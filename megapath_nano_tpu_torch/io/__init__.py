"""Read input (FASTQ / FASTA with QC) and adapter trimming."""

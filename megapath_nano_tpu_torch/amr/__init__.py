"""AMR detection: consensus contigs, gene-DB scans and the report."""

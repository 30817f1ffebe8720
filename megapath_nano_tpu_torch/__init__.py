"""megapath_nano_tpu_torch — the PyTorch / CUDA port of megapath_nano_tpu.

It covers the taxon profile (`taxon.profiler.TaxonProfiler(db, options,
device=...).profile(reads)` and `write_reports`, and the profile CLI
`python -m megapath_nano_tpu_torch.cli.main`: read QC, adapter trimming,
human/decoy filters, placement, the noise stack, best alignment, abundance,
the report files) and, under it, the map step, `MinimizerAligner.map_reads`,
in both modes: PAF mode (`emit_cigars=False`: one fused device dispatch per
slice) and the host-chained CIGAR-emit mode (`emit_cigars=True`, also every
PAF problem outside the fused gate), and the SAM / PAF writers. Every map of
a profile (placement, filter DBs, genome-vs-genome filters, noise
projection) runs on the profiler's device. Device seeding runs as torch
ops; the chain DP, the full-stats banded extension and the score-only
banded extension are hand-written CUDA kernels for Hopper (sm_90a); the
traceback of reported alignments is the native C++ banded aligner. Entry
points run on the GPU unless the caller passes `device="cpu"`, where the
kernel wrappers run their plain PyTorch versions.

Layer map:
  cli/       the profile CLI (main)
  taxon/     the profile driver (profiler), its noise stack
             (genome_filters, noise_projection, filters, reassign,
             noise_stats, bed_cache), abundance, best alignment, BED algebra
  db/        RefDB: sequences, taxonomy, index; the on-disk format is shared
             with megapath_nano_tpu
  io/        FASTQ / FASTA with QC, adapter trimming
  align/     seed -> chain -> extend map path (pipeline, device_seed, chain),
             host anchor collection (anchors) and the AlignList schema
             (records)
  kernels/   CUDA kernels (csrc/), their wrappers and plain versions, and the
             nvcc build
  index/     minimizer index (native build, sorted-array layout)
  native/    ctypes bindings to the C++ host layer in cpp/ (SSW, banded
             traceback, index, FASTQ), built by the port's own loader into
             megapath_nano_tpu_torch/build/
  report/    report writers, histograms, SAM / PAF writers
  sim/       read simulator (noise projection)
  utils/     DNA encoding helpers, step log
  state.py   the TPU package's index, RefDB and device planes carried across
  buildutil.py  locked, cached build-at-first-use shared by both loaders

The package imports torch and numpy only: nothing of jax and nothing of the
megapath_nano_tpu package, whose host-only modules it carries as copies of
its own (everything but align/pipeline, align/device_seed, kernels/ and
state.py). megapath_nano_tpu stays the reference the tests hold it to.
"""

__version__ = "0.2.0"

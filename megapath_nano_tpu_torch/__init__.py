"""megapath_nano_tpu_torch — the PyTorch / CUDA port of megapath_nano_tpu.

It covers the map step, `MinimizerAligner.map_reads`, in both modes: PAF
mode (`emit_cigars=False`: one fused device dispatch per slice) and the
host-chained CIGAR-emit mode (`emit_cigars=True`, also every PAF problem
outside the fused gate), and the SAM / PAF writers. Device seeding runs as
torch ops; the chain DP, the full-stats banded extension and the score-only
banded extension are hand-written CUDA kernels for Hopper (sm_90a); the
traceback of reported alignments is the native C++ banded aligner. Entry
points run on the GPU unless the caller passes `device="cpu"`, where the
kernel wrappers run their plain PyTorch versions.

Layer map:
  align/     seed -> chain -> extend map path (pipeline, device_seed, chain),
             host anchor collection (anchors) and the AlignList schema
             (records)
  kernels/   CUDA kernels (csrc/), their wrappers and plain versions, and the
             nvcc build
  index/     minimizer index (native build, sorted-array layout)
  native/    ctypes bindings to the C++ host layer in cpp/, built by the
             port's own loader into megapath_nano_tpu_torch/build/
  report/    SAM / PAF writers
  utils/     DNA encoding helpers
  state.py   the TPU package's index and device planes carried across
  buildutil.py  locked, cached build-at-first-use shared by both loaders

The package imports torch and numpy only: nothing of jax and nothing of the
megapath_nano_tpu package, whose host-only modules it carries as copies of
its own (index, anchors, records, native, utils, samout). megapath_nano_tpu
stays the reference the tests hold it to.
"""

__version__ = "0.2.0"

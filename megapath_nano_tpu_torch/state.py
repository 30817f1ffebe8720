"""State carried across from the TPU package: the host index
(`index_from_numpy`), the reference DB of the taxon profile
(`refdb_from_numpy`), an AMR gene DB (`amr_db_from_numpy`) and the device
planes (`device_planes_from_numpy`). There are no weights on these paths;
the reference DB (sequences, taxonomy, minimizer index), the gene DBs and
the 4-bit packed reference are their state.

The TPU package's MinimizerAligner keeps these arrays on its device (built
on the host from the MinimizerIndex):

  seq4         uint8  4-bit packed reference (2 codes/byte, high nibble
                      first) with a 2**15-code sentinel tail of 5
  seq_offsets  int32  per-sequence start in the flat reference
  seq_lengths  int32  per-sequence length
  keys32       int32  sorted minimizer hash table (hashes < 2**30)
  pos_t        int32  per-entry k-mer end position within its sequence
  ss16         uint16 per-entry seq_id << 1 | strand
  lut2         int32  (2**lut_bits, 2) paired bucket bounds into keys32
  runcnt       uint8  equal-key run length at each run start (clipped 255)

`device_planes_from_numpy` carries any of them into the port's tensors on a
given device; the port's MinimizerAligner builds its state through it, and a
caller holding the TPU aligner's arrays can carry them over the same way.
ss16 widens to int32 on the device, since torch's uint16 supports too few
ops for the seed stage's gathers and shifts: that costs 2 more bytes per
index entry (8 bytes of position planes per entry instead of 6).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from megapath_nano_tpu_torch.amr.db import AMRGeneDB
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex

# name -> (dtype the TPU aligner holds, dtype of the port's tensor)
PLANES = {
    "seq4": (np.uint8, torch.uint8),
    "seq_offsets": (np.int32, torch.int32),
    "seq_lengths": (np.int32, torch.int32),
    "keys32": (np.int32, torch.int32),
    "pos_t": (np.int32, torch.int32),
    "ss16": (np.uint16, torch.int32),
    "lut2": (np.int32, torch.int32),
    "runcnt": (np.uint8, torch.uint8),
}


def device_planes_from_numpy(arrays: Mapping[str, np.ndarray], *,
                             device) -> dict[str, torch.Tensor]:
    """Carry numpy planes (any subset of PLANES, in the TPU aligner's
    dtypes) to tensors on `device`, in the port's dtypes."""
    out = {}
    for name, arr in arrays.items():
        if name not in PLANES:
            raise ValueError(f"unknown plane {name!r}; expected one of "
                             f"{sorted(PLANES)}")
        np_dtype, torch_dtype = PLANES[name]
        arr = np.asarray(arr)
        if arr.dtype != np_dtype:
            raise ValueError(f"plane {name!r} must be {np.dtype(np_dtype)}; "
                             f"got {arr.dtype}")
        host = np.ascontiguousarray(
            arr.astype(np.int32) if torch_dtype == torch.int32 else arr)
        if not host.flags.writeable:     # e.g. a view of a JAX array
            host = host.copy()
        out[name] = torch.from_numpy(host).to(device=device,
                                              dtype=torch_dtype)
    return out


def index_from_numpy(src) -> MinimizerIndex:
    """Build the port's MinimizerIndex from the arrays of any object with the
    same fields (the TPU package's MinimizerIndex, or a loaded archive),
    field for field, without rebuilding. The arrays are shared, not
    copied; the lazily built lookup LUT is left to be rebuilt."""
    def arr(x, dtype):
        return None if x is None else np.ascontiguousarray(x, dtype)

    return MinimizerIndex(
        k=int(src.k), w=int(src.w),
        keys=arr(src.keys, np.uint64),
        positions=arr(src.positions, np.uint64),
        seq_lengths=arr(src.seq_lengths, np.int64),
        seq_names=list(src.seq_names),
        seq_data=arr(src.seq_data, np.int8),
        seq_offsets=arr(src.seq_offsets, np.int64))


def refdb_from_numpy(src):
    """Build the port's RefDB from any object with the same fields (the TPU
    package's RefDB), field for field: the index through `index_from_numpy`,
    not rebuilt, and the tables shared, not copied."""
    # imported here: db.refdb imports align.pipeline, which imports this
    from megapath_nano_tpu_torch.db.refdb import RefDB

    return RefDB(
        index=index_from_numpy(src.index),
        seq_assembly=np.asarray(src.seq_assembly),
        assembly_names=list(src.assembly_names),
        assembly_lengths=np.asarray(src.assembly_lengths),
        assembly_tax=np.asarray(src.assembly_tax),
        tax_names=dict(src.tax_names))


def amr_db_from_numpy(src):
    """Build the port's AMRGeneDB from any object with the same fields (the
    TPU package's AMRGeneDB), field for field: the gene index, when `src`
    has built one, through `index_from_numpy`, not rebuilt; the sequences
    shared, not copied."""
    index = getattr(src, "_index", None)
    return AMRGeneDB(
        name=src.name, gene_names=list(src.gene_names),
        sequences=[np.asarray(s) for s in src.sequences],
        drugs=[list(d) for d in src.drugs], classes=list(src.classes),
        accessions=list(src.accessions), taxa=list(src.taxa),
        _index=None if index is None else index_from_numpy(index))

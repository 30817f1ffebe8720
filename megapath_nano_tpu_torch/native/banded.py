"""Batched banded alignment with traceback (native, threaded).

The emit path for reported alignments: O(band * len) per pair, CIGARs +
match/NM counts, with the same band geometry as the banded scoring kernel
(kernels/sw.py). The port's own copy of megapath_nano_tpu/native/banded.py.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.native.lib import MpnBandedResult, load_native_lib

CIGAR_OPS = "MIDNSHP=X"


@dataclass
class BandedAlignment:
    score: int
    read_begin: int
    read_end: int       # inclusive
    ref_begin: int
    ref_end: int        # inclusive
    n_match: int
    n_mismatch: int
    n_ins: int
    n_del: int
    cigar: list[tuple[int, str]]

    @property
    def edit_dist(self) -> int:
        return self.n_mismatch + self.n_ins + self.n_del

    @property
    def cigar_string(self) -> str:
        return "".join(f"{l}{op}" for l, op in self.cigar)


def banded_align_batch(
    reads: list[np.ndarray],
    refs: list[np.ndarray],
    *,
    band: int = 256,
    match: int = 2,
    mismatch: int = 4,
    gap_open: int = 4,
    gap_extend: int = 2,
    n_threads: int | None = None,
) -> list[BandedAlignment]:
    lib = load_native_lib()
    n = len(reads)
    if n == 0:
        return []
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    read_flat = np.concatenate([np.asarray(r, np.int8) for r in reads])
    ref_flat = np.concatenate([np.asarray(r, np.int8) for r in refs])
    ro = np.zeros(n + 1, np.int64)
    to = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=ro[1:])
    np.cumsum([len(r) for r in refs], out=to[1:])
    # cigar capacity: one op per read base + slack
    co = np.zeros(n + 1, np.int64)
    np.cumsum([2 * len(r) + 8 for r in reads], out=co[1:])
    cigar_buf = np.zeros(int(co[-1]), np.uint32)
    results = (MpnBandedResult * n)()

    i8p = ctypes.POINTER(ctypes.c_int8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mpn_banded_align_batch(
        read_flat.ctypes.data_as(i8p), ro.ctypes.data_as(i64p),
        ref_flat.ctypes.data_as(i8p), to.ctypes.data_as(i64p),
        n, band, match, mismatch, gap_open, gap_extend, n_threads,
        results, cigar_buf.ctypes.data_as(u32p), co.ctypes.data_as(i64p))

    out = []
    for p in range(n):
        r = results[p]
        cig = [(int(c) >> 4, CIGAR_OPS[int(c) & 0xF])
               for c in cigar_buf[co[p]: co[p] + r.cigar_len]]
        out.append(BandedAlignment(
            r.score, r.read_begin, r.read_end, r.ref_begin, r.ref_end,
            r.n_match, r.n_mismatch, r.n_ins, r.n_del, cig))
    return out

"""High-level SSW alignment API over the native library.

Observable behavior is identical to the reference's libssw
(reference: bin/realignment/realign/ssw.c:762 ssw_align, as driven by
bin/realignment/pyssw.py:52 with match=4 mismatch=6 gapO=8 gapE=2).

The port's own copy of megapath_nano_tpu/native/ssw.py.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.native.lib import MpnAlignResult, load_native_lib

CIGAR_OPS = "MIDNSHP=X"


def build_score_matrix(match: int, mismatch: int, n: int = 5) -> np.ndarray:
    """n x n substitution matrix: +match on diagonal, -mismatch elsewhere,
    0 for the ambiguous code (row/col n-1), mirroring pyssw.py:68-78."""
    mat = np.full((n, n), -mismatch, dtype=np.int8)
    np.fill_diagonal(mat, match)
    mat[n - 1, :] = 0
    mat[:, n - 1] = 0
    return mat


@dataclass
class Alignment:
    score1: int
    score2: int
    ref_begin: int
    ref_end: int
    read_begin: int
    read_end: int
    ref_end2: int
    cigar: list[tuple[int, str]]  # [(length, op)]

    @property
    def cigar_string(self) -> str:
        return "".join(f"{l}{op}" for l, op in self.cigar)


def ssw_align(
    read: np.ndarray,
    ref: np.ndarray,
    *,
    match: int = 4,
    mismatch: int = 6,
    gap_open: int = 8,
    gap_extend: int = 2,
    mask_len: int | None = None,
    want_cigar: bool = True,
    score_matrix: np.ndarray | None = None,
) -> Alignment:
    """Affine-gap local alignment of numeric sequences (codes 0..4)."""
    lib = load_native_lib()
    read = np.ascontiguousarray(read, dtype=np.int8)
    ref = np.ascontiguousarray(ref, dtype=np.int8)
    if score_matrix is None:
        score_matrix = build_score_matrix(match, mismatch)
    mat = np.ascontiguousarray(score_matrix, dtype=np.int8)
    n = mat.shape[0]
    if mask_len is None:
        mask_len = max(len(read) // 2, 15)

    result = MpnAlignResult()
    cigar_cap = 2 * (len(read) + 8)
    cigar_buf = np.zeros(cigar_cap, dtype=np.uint32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    rc = lib.mpn_ssw_align(
        read.ctypes.data_as(i8p), len(read),
        ref.ctypes.data_as(i8p), len(ref),
        mat.ctypes.data_as(i8p), n,
        gap_open, gap_extend, mask_len,
        1 if want_cigar else 0,
        ctypes.byref(result),
        cigar_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cigar_cap,
    )
    if rc != 0:
        raise RuntimeError(f"mpn_ssw_align failed with code {rc}")
    cigar = [
        (int(c) >> 4, CIGAR_OPS[int(c) & 0xF])
        for c in cigar_buf[: result.cigar_len]
    ]
    return Alignment(
        score1=result.score1,
        score2=result.score2,
        ref_begin=result.ref_begin1,
        ref_end=result.ref_end1,
        read_begin=result.read_begin1,
        read_end=result.read_end1,
        ref_end2=result.ref_end2,
        cigar=cigar,
    )


def ssw_align_batch(
    reads: list[np.ndarray],
    refs: list[np.ndarray],
    *,
    match: int = 4,
    mismatch: int = 6,
    gap_open: int = 8,
    gap_extend: int = 2,
    mask_len: int = 15,
    want_cigar: bool = True,
) -> list[Alignment]:
    """Batch alignment of paired (read, ref) numeric sequences."""
    lib = load_native_lib()
    n_pairs = len(reads)
    assert len(refs) == n_pairs
    read_flat = np.concatenate([np.asarray(r, dtype=np.int8) for r in reads]) if n_pairs else np.zeros(0, np.int8)
    ref_flat = np.concatenate([np.asarray(r, dtype=np.int8) for r in refs]) if n_pairs else np.zeros(0, np.int8)
    read_off = np.zeros(n_pairs + 1, dtype=np.int64)
    ref_off = np.zeros(n_pairs + 1, dtype=np.int64)
    np.cumsum([len(r) for r in reads], out=read_off[1:])
    np.cumsum([len(r) for r in refs], out=ref_off[1:])
    mat = build_score_matrix(match, mismatch)

    results = (MpnAlignResult * n_pairs)()
    cigar_cap = int(2 * (read_flat.size + 8 * n_pairs) + 16)
    cigar_buf = np.zeros(cigar_cap, dtype=np.uint32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mpn_ssw_align_batch(
        read_flat.ctypes.data_as(i8p), read_off.ctypes.data_as(i64p),
        ref_flat.ctypes.data_as(i8p), ref_off.ctypes.data_as(i64p),
        n_pairs, mat.ctypes.data_as(i8p), mat.shape[0],
        gap_open, gap_extend, mask_len, 1 if want_cigar else 0,
        results,
        cigar_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cigar_cap,
    )
    out = []
    pos = 0
    for p in range(n_pairs):
        r = results[p]
        cigar = [
            (int(c) >> 4, CIGAR_OPS[int(c) & 0xF])
            for c in cigar_buf[pos: pos + r.cigar_len]
        ]
        pos += r.cigar_len
        out.append(Alignment(r.score1, r.score2, r.ref_begin1, r.ref_end1,
                             r.read_begin1, r.read_end1, r.ref_end2, cigar))
    return out

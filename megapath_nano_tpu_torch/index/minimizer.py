"""Minimizer index: host build (native), device-friendly sorted-array layout.

The reference seeds alignments with minimap2's minimizer index
(reference: bin/lib/aligner.py:206, `-x map-ont` => k=15, w=10). Here the index
is two sorted flat arrays (hash keys + packed positions) so that device-side
lookup is a bucket-LUT + bounded bisection over a device-resident table
(align/device_seed.py) instead of a pointer-chasing hash table.

The port's own copy of megapath_nano_tpu/index/minimizer.py: numpy and ctypes
only, bound to the port's native loader. The dataclass has the same fields, so
an index built by either package carries over field for field
(state.index_from_numpy).

Position packing (uint64): seq_id:24 | kmer_end_pos:39 | strand:1.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.native.lib import load_native_lib

POS_BITS = 39
SEQ_SHIFT = POS_BITS + 1
POS_MASK = (1 << POS_BITS) - 1


@dataclass
class MinimizerIndex:
    """Sorted minimizer table over a set of target sequences."""

    k: int
    w: int
    keys: np.ndarray        # (n,) uint64, ascending
    positions: np.ndarray   # (n,) uint64 packed
    seq_lengths: np.ndarray  # (n_seqs,) int64
    seq_names: list[str]
    # concatenated numeric target sequences + offsets, for extension stage
    seq_data: np.ndarray | None = None
    seq_offsets: np.ndarray | None = None
    _lut: np.ndarray | None = None     # bucket LUT for the native lookup
    _lut_bits: int = 0

    @property
    def num_minimizers(self) -> int:
        return len(self.keys)

    def _ensure_lut(self):
        if self._lut is None:
            bits = max(8, min(16, int(np.log2(max(len(self.keys), 2))) - 3))
            bounds = (np.arange(2 ** bits + 1, dtype=np.uint64)
                      << np.uint64(64 - bits))
            bounds[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
            lut = np.searchsorted(self.keys, bounds).astype(np.int64)
            lut[-1] = len(self.keys)
            self._lut = lut
            self._lut_bits = bits
        return self._lut, self._lut_bits

    def anchor_arrays(self, flat: np.ndarray, offsets: np.ndarray, *,
                      max_occ: int = 64, n_threads: int = 2):
        """Fused native sketch → lookup → hit expansion → per-read sort.

        flat/offsets: concatenated numeric reads. Returns
        (q, t, seq, strand, read_offsets): flat anchor arrays ordered by
        (read, seq, strand, t, q) — read r's anchors at
        [read_offsets[r], read_offsets[r+1]). One native call replaces the
        four-step host path (its lexsort was the single hottest numpy op)."""
        import ctypes

        from megapath_nano_tpu_torch.native.lib import load_native_lib

        lib = load_native_lib()
        lut, bits = self._ensure_lut()
        n = len(offsets) - 1
        c = ctypes
        i8p = c.POINTER(c.c_int8)
        i32p = c.POINTER(c.c_int32)
        i64p = c.POINTER(c.c_int64)
        u64p = c.POINTER(c.c_uint64)
        h = lib.mpn_anchors_build(
            np.ascontiguousarray(flat, np.int8).ctypes.data_as(i8p),
            np.ascontiguousarray(offsets, np.int64).ctypes.data_as(i64p),
            n, self.k, self.w,
            self.keys.ctypes.data_as(u64p), len(self.keys),
            self.positions.ctypes.data_as(u64p),
            lut.ctypes.data_as(i64p), bits, max_occ, n_threads)
        total = lib.mpn_anchors_total(h)
        q = np.zeros(total, np.int32)
        t = np.zeros(total, np.int64)
        seq = np.zeros(total, np.int32)
        strand = np.zeros(total, np.int8)
        roffs = np.zeros(n + 1, np.int64)
        lib.mpn_anchors_export(
            h, q.ctypes.data_as(i32p), t.ctypes.data_as(i64p),
            seq.ctypes.data_as(i32p), strand.ctypes.data_as(i8p),
            roffs.ctypes.data_as(i64p))
        return q, t, seq, strand, roffs

    def lookup_ranges(self, hashes: np.ndarray, n_threads: int = 2):
        """[lo, hi) range in `keys` per query hash — LUT-bucketed native
        binary search (hashes are avalanche-mixed, so top-bit buckets are
        uniform; each search touches ~2 cache lines)."""
        import ctypes

        from megapath_nano_tpu_torch.native.lib import load_native_lib

        lib = load_native_lib()
        self._ensure_lut()
        lo = np.zeros(len(hashes), np.int64)
        hi = np.zeros(len(hashes), np.int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.mpn_lookup_lut(
            self.keys.ctypes.data_as(u64p), len(self.keys),
            self._lut.ctypes.data_as(i64p), self._lut_bits,
            np.ascontiguousarray(hashes).ctypes.data_as(u64p),
            len(hashes), lo.ctypes.data_as(i64p), hi.ctypes.data_as(i64p),
            n_threads)
        return lo, hi

    @staticmethod
    def build(
        seqs: list[np.ndarray],
        names: list[str] | None = None,
        *,
        k: int = 15,
        w: int = 10,
        keep_seq: bool = True,
        n_threads: int | None = None,
    ) -> "MinimizerIndex":
        from megapath_nano_tpu_torch.native.lib import default_threads

        lib = load_native_lib()
        if n_threads is None:
            n_threads = default_threads()
        n_seqs = len(seqs)
        flat = (
            np.concatenate([np.asarray(s, dtype=np.int8) for s in seqs])
            if n_seqs else np.zeros(0, np.int8)
        )
        offsets = np.zeros(n_seqs + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])

        i8p = ctypes.POINTER(ctypes.c_int8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        h = lib.mpn_index_build(flat.ctypes.data_as(i8p),
                                offsets.ctypes.data_as(i64p), n_seqs, k, w,
                                n_threads)
        try:
            n = lib.mpn_index_size(h)
            keys = np.zeros(n, dtype=np.uint64)
            positions = np.zeros(n, dtype=np.uint64)
            if n:
                lib.mpn_index_copy(h, keys.ctypes.data_as(u64p),
                                   positions.ctypes.data_as(u64p))
        finally:
            lib.mpn_index_free(h)
        return MinimizerIndex(
            k=k, w=w, keys=keys, positions=positions,
            seq_lengths=np.diff(offsets),
            seq_names=names or [f"seq{i}" for i in range(n_seqs)],
            seq_data=flat if keep_seq else None,
            seq_offsets=offsets if keep_seq else None,
        )

    def unpack(self, packed: np.ndarray):
        """packed -> (seq_id, pos, strand) arrays."""
        packed = packed.astype(np.uint64)
        seq_id = (packed >> np.uint64(SEQ_SHIFT)).astype(np.int32)
        pos = ((packed >> np.uint64(1)) & np.uint64(POS_MASK)).astype(np.int64)
        strand = (packed & np.uint64(1)).astype(np.int8)
        return seq_id, pos, strand


def sketch_batch(seqs: list[np.ndarray] | np.ndarray,
                 offsets: np.ndarray | None = None, *, k: int = 15,
                 w: int = 10):
    """Sketch many reads in one native call.

    Returns (hashes, end_positions, strands, read_offsets) — flat arrays with
    read r's minimizers at [read_offsets[r], read_offsets[r+1])."""
    lib = load_native_lib()
    if offsets is None:
        n = len(seqs)
        flat = (np.concatenate([np.asarray(s, np.int8) for s in seqs])
                if n else np.zeros(0, np.int8))
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
    else:
        flat = np.ascontiguousarray(seqs, dtype=np.int8)
        n = len(offsets) - 1
    i8p = ctypes.POINTER(ctypes.c_int8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    # one call: minimizer count can never exceed the k-mer count, so the
    # total base count is a safe capacity bound
    cap = max(int(flat.size), 1)
    hashes = np.zeros(cap, np.uint64)
    pos = np.zeros(cap, np.int64)
    strand = np.zeros(cap, np.int8)
    out_off = np.zeros(n + 1, np.int64)
    total = lib.mpn_sketch_batch(flat.ctypes.data_as(i8p),
                                 offsets.ctypes.data_as(i64p), n, k, w,
                                 hashes.ctypes.data_as(u64p),
                                 pos.ctypes.data_as(i64p),
                                 strand.ctypes.data_as(i8p),
                                 out_off.ctypes.data_as(i64p), cap)
    return hashes[:total], pos[:total], strand[:total], out_off


def sketch(seq: np.ndarray, *, k: int = 15, w: int = 10):
    """Minimizers of a single sequence, in order of occurrence.

    Returns (hashes uint64, end_positions int64, strands int8).
    """
    lib = load_native_lib()
    seq = np.ascontiguousarray(seq, dtype=np.int8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.mpn_sketch(seq.ctypes.data_as(i8p), len(seq), k, w, None, None,
                       None, 0)
    hashes = np.zeros(n, dtype=np.uint64)
    pos = np.zeros(n, dtype=np.int64)
    strand = np.zeros(n, dtype=np.int8)
    if n:
        lib.mpn_sketch(seq.ctypes.data_as(i8p), len(seq), k, w,
                       hashes.ctypes.data_as(u64p),
                       pos.ctypes.data_as(i64p),
                       strand.ctypes.data_as(i8p), n)
    return hashes, pos, strand

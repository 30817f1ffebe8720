"""Seed -> chain -> extend map path in PyTorch.

Port of megapath_nano_tpu.align.pipeline, both branches of `map_reads`.

The fused branch (PAF mode, `emit_cigars=False`, inside the fused gate): one
slice of reads is one device dispatch (`_fused_map_dispatch_devseed`: read
unpack, device seeding, chain DP, per-read top-K gate and compaction, window
algebra, query/target gathers, full-stats banded extension), and the host
reads back one row matrix and builds an AlignList (`fused_collect_np`). When
a static cap overflows, only the cut-off read-id suffix re-runs through the
host-seeded dispatch (`_fused_map_dispatch`), the partial redo.

The host-chained branch (`emit_cigars=True`, and every PAF problem outside
the fused gate, `MinimizerAligner._map_host`) runs as stages over one
columnar `WindowTable`: host seeding, chain kernel in 4096-group chunks,
top-K windows, device extension (full statistics in PAF mode below 2**15,
else score only), multi-locus selection, native traceback cross-checked
against the device score, and emit (CIGARs in `AlignList.cigar_map`).

The device functions take and return torch tensors on one device; the
kernels (chain DP, banded extension) run as CUDA kernels on a CUDA device and
as their plain versions on the CPU. The result rows come back as int32
masked with 0xFFFF and become numpy uint16 on the host (torch's uint16
supports too few ops to compute in).

The host helpers below (`AlignParams` through `_unpack_counts_row`) are
copies of the TPU package's; the AlignList parity tests hold the copies to
the originals.
"""

from __future__ import annotations

import contextvars
import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from megapath_nano_tpu_torch.align.anchors import (collect_anchors,
                                                   pack_groups,
                                                   pack_groups_flat)
from megapath_nano_tpu_torch.align.chain import chain_and_extents
from megapath_nano_tpu_torch.align.device_seed import (NO_RID,
                                                       build_groups_device)
from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE, AlignList
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.kernels.sw import (banded_sw_full,
                                                banded_sw_scores)
from megapath_nano_tpu_torch.native.banded import banded_align_batch
from megapath_nano_tpu_torch.state import device_planes_from_numpy
from megapath_nano_tpu_torch.utils.dna import revcomp
from megapath_nano_tpu_torch.utils.log import count, span

# ---------------------------------------------------------------------------
# device part


def _unpack_reads(packed2, exc_rid, exc_pos):
    """Unpack 2-bit read codes to an (n, read_max) int8 matrix; restore the
    rare non-ACGT codes (4) from the exception lists. Padding exceptions
    carry rid = n and are dropped."""
    n, nb = packed2.shape
    shifts = torch.tensor([6, 4, 2, 0], dtype=torch.uint8,
                          device=packed2.device)
    codes = ((packed2[:, :, None] >> shifts) & 3).reshape(n, nb * 4)
    codes = torch.cat([codes.to(torch.int8),
                       torch.zeros((1, nb * 4), dtype=torch.int8,
                                   device=packed2.device)])
    ok = (exc_rid >= 0) & (exc_rid < n) & (exc_pos >= 0) & (exc_pos < nb * 4)
    codes[torch.where(ok, exc_rid, n).long(),
          torch.where(ok, exc_pos, 0).long()] = 4
    return codes[:n]


def _gather_windows(seq4, starts, *, t_max: int):
    """Gather (n, t_max) reference windows from the 4-bit packed reference
    (2 codes/byte, high nibble first). Byte starts are clamped to
    [0, len - nb] as XLA clamps a dynamic slice, so a window near the end of
    the sentinel tail shifts instead of reading out of bounds."""
    nb = t_max // 2 + 1
    dev = seq4.device
    s = (starts >> 1).clamp(0, seq4.shape[0] - nb)
    rows = seq4[(s[:, None] + torch.arange(nb, device=dev)[None, :]).long()]
    codes = torch.stack([(rows >> 4) & 0xF, rows & 0xF],
                        dim=-1).reshape(rows.shape[0], 2 * nb)
    off = (starts & 1).clamp(0, 2 * nb - t_max)
    cols = off[:, None].long() + torch.arange(t_max, device=dev)[None, :]
    return torch.gather(codes, 1, cols).to(torch.int8)


def _gather_queries(codes, rid, qlens, qs, wlen, strand, *, q_max: int):
    """Oriented query windows: row r is (revcomp(read) if strand else
    read)[qs : qs + wlen], padded with 4."""
    dev = codes.device
    L = codes.shape[1]
    ridl = rid.clamp(0, codes.shape[0] - 1).long()
    rows = codes[ridl]
    ql = qlens[ridl]
    rc = torch.where(rows < 4, 3 - rows, rows).flip(1)
    minus = strand == 1
    base = torch.where(minus[:, None], rc, rows)
    start = (qs + torch.where(minus, L - ql, 0)).clamp(0, L)
    basep = torch.cat([base, torch.full((base.shape[0], q_max), 4,
                                        dtype=base.dtype, device=dev)], 1)
    cols = torch.arange(q_max, device=dev)[None, :]
    win = torch.gather(basep, 1, start[:, None].long() + cols)
    valid = (cols < wlen[:, None]) & (cols < (ql - qs)[:, None])
    return torch.where(valid, win, 4).to(torch.int8)


def _extend_full_dispatch(packed2, exc_rid, exc_pos, qlens, meta, seq_data,
                          *, q_max, t_max, band, match, mismatch, gap_open,
                          gap_extend):
    """PAF extension of host-chosen candidates: gather oriented query
    windows from the packed read matrix and target windows from the resident
    reference, then run the full-stats banded extension. meta rows (int32):
    rid, qs, qwlen, strand, t_start, t_len."""
    rid, qs, qwlen, strand, t_start, t_len = meta.unbind(0)
    codes = _unpack_reads(packed2, exc_rid, exc_pos)
    ra = _gather_queries(codes, rid, qlens, qs, qwlen, strand, q_max=q_max)
    ta = _gather_windows(seq_data, t_start, t_max=t_max)
    return banded_sw_full(ra, qwlen, ta, t_len, band=band, match=match,
                          mismatch=mismatch, gap_open=gap_open,
                          gap_extend=gap_extend)


def _goffs_from_cnt(cnt):
    """Exclusive prefix sum of per-group anchor counts (row offsets into the
    ragged anchor arrays)."""
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=cnt.device),
                      torch.cumsum(cnt, dim=0, dtype=torch.int32)])


def _fused_tail(codes, qlens, qg, tg, cnt, rid, seqid, strand, t_base,
                seq_data, seq_offsets, seq_lengths, *, k, q_max, t_max, band,
                match, mismatch, gap_open, gap_extend, min_chain_score,
                max_per_read, window_pad, ext_cap: int | None = None):
    """Shared device tail of the fused map step: chain DP -> per-read top-K
    gate -> extension-window algebra -> query/target gathers -> full-stats
    banded extension.

    Returns ((G, 16) int32 row matrix holding uint16 values, n_keep,
    minrid_out — the smallest read id whose kept rows were cut by ext_cap,
    NO_RID when none or when ext_cap is None). Row layout (FUSED_COLS):
    score, end_i, end_j, match, edit, begin_i, begin_j, keep, qs,
    w_lo_lo16, w_lo_hi16, rid, seq_id, strand, chain score, 0.
    """
    i32 = torch.int32
    dev = codes.device
    stacked = chain_and_extents(qg, tg, cnt)
    best = stacked[0]
    q_min, q_maxx, t_min, t_maxx = stacked[1:5]
    G = best.shape[0]

    # per-read rank by chain score (stable: group order breaks ties)
    comp = rid * (1 << 15) + ((1 << 15) - 1
                              - torch.clamp(best, max=(1 << 15) - 1))
    order = torch.argsort(comp, stable=True)
    rid_s = rid[order]
    ar = torch.arange(G, dtype=i32, device=dev)
    newrun = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        rid_s[1:] != rid_s[:-1]])
    run_start = torch.cummax(torch.where(newrun, ar, 0), dim=0).values
    rank = torch.zeros(G, dtype=i32, device=dev).scatter_(0, order,
                                                          ar - run_start)
    keep = (best >= min_chain_score) & (rank < max_per_read) & (cnt > 0)
    n_keep = keep.sum(dtype=i32)

    minrid_out = torch.tensor(NO_RID, dtype=i32, device=dev)
    if ext_cap is not None:
        # rows are read-id-major, so ext_cap drops a rid suffix; its start
        # feeds the host's partial redo. Stable compaction keeps group order.
        rank_keep = torch.cumsum(keep.to(i32), dim=0, dtype=i32) - 1
        minrid_out = torch.where(keep & (rank_keep >= ext_cap), rid,
                                 NO_RID).min()
        corder = torch.argsort((~keep).to(torch.uint8), stable=True)[:ext_cap]
        (best, q_min, q_maxx, t_min, t_maxx, rid, seqid, strand, t_base,
         cnt, keep) = (x[corder] for x in
                       (best, q_min, q_maxx, t_min, t_maxx, rid, seqid,
                        strand, t_base, cnt, keep))
        G = ext_cap

    # extension-window algebra; the diagonal back-shift for widened bands
    # is zero at band 128
    pad = window_pad
    dshift = min(band // 8, 64) if band > 128 else 0
    qlen_g = qlens[rid.long()]
    q_lo = q_min - (k - 1)
    q_hi = q_maxx + 1
    t_lo = t_min + t_base - (k - 1)
    t_hi = t_maxx + t_base + 1
    seq_off = seq_offsets[seqid.long()]
    seq_len = seq_lengths[seqid.long()]
    left = torch.minimum(q_lo, t_lo) + pad
    right = torch.minimum(qlen_g - q_hi, seq_len - t_hi) + pad
    qs = torch.clamp(q_lo - left, min=0)
    qe = torch.minimum(q_hi + right, qlen_g)
    w_lo = torch.clamp(t_lo - (q_lo - qs) - dshift, min=0)
    w_hi = torch.minimum(t_hi + (qe - q_hi) + dshift, seq_len)
    rl = torch.where(keep, qe - qs, 0).to(i32)
    tl = torch.where(keep, torch.clamp(w_hi - w_lo, max=t_max), 0).to(i32)
    start = torch.where(keep, seq_off + w_lo, 0).to(i32)

    ra = _gather_queries(codes, rid, qlens, qs.to(i32), rl, strand,
                         q_max=q_max)
    ta = _gather_windows(seq_data, start, t_max=t_max)
    full = banded_sw_full(ra, rl, ta, tl, band=band, match=match,
                          mismatch=mismatch, gap_open=gap_open,
                          gap_extend=gap_extend)
    zero = torch.zeros(G, dtype=i32, device=dev)
    extra = torch.stack([keep.to(i32), qs.to(i32), w_lo & 0xFFFF, w_lo >> 16,
                         rid, seqid, strand.to(i32),
                         torch.clamp(best, 0, (1 << 15) - 1), zero], dim=1)
    out = torch.cat([full, extra.to(i32)], dim=1) & 0xFFFF
    return out, n_keep, minrid_out


# _fused_tail row layout (uint16 columns)
FUSED_COLS = 16
(F_SCORE, F_END_I, F_END_J, F_MATCH, F_EDIT, F_BEGIN_I, F_BEGIN_J, F_KEEP,
 F_QS, F_WLO_LO, F_WLO_HI, F_RID, F_SEQ, F_STRAND, F_CHAIN) = range(15)


def _pack_counts_row(counts_i32):
    """Pack a (5,) int32 counts vector into one (1, FUSED_COLS) row of
    uint16 values (lo/hi halves interleaved): [tot_winners, tot_anchors,
    n_groups_kept, n_keep, min_affected_rid]."""
    row = torch.zeros(FUSED_COLS, dtype=torch.int32, device=counts_i32.device)
    row[0:10:2] = counts_i32 & 0xFFFF
    row[1:10:2] = (counts_i32 >> 16) & 0xFFFF
    return row[None, :]


def _fused_map_dispatch(packed2, exc_rid, exc_pos, qlens, flat_q, flat_t,
                        gmeta, seq_data, seq_offsets, seq_lengths, *, k,
                        a_bucket, q_max, t_max, band, match, mismatch,
                        gap_open, gap_extend, min_chain_score, max_per_read,
                        window_pad):
    """Host-seeded fused map step: ragged anchors (flat_q/flat_t + per-group
    counts) are padded to (n_groups, a_bucket) by a gather, then the shared
    tail runs. gmeta rows (int32): rid, seq_id, strand, t_base, n_anchors.
    Returns (G+1, FUSED_COLS) int32 rows holding uint16 values, the last one
    the counts row [0, 0, 0, n_keep, NO_RID]."""
    dev = packed2.device
    rid, seqid, strand, t_base, cnt = gmeta.unbind(0)
    goffs = _goffs_from_cnt(cnt)
    a_cols = torch.arange(a_bucket, dtype=torch.int32, device=dev)[None, :]
    srcs = (goffs[:-1, None] + a_cols).clamp(0, flat_q.shape[0] - 1).long()
    a_mask = a_cols < cnt[:, None]
    qg = torch.where(a_mask, flat_q[srcs].to(torch.int32), 0)
    tg = torch.where(a_mask, flat_t[srcs].to(torch.int32), 0)
    codes = _unpack_reads(packed2, exc_rid, exc_pos)
    out, n_keep, _minrid = _fused_tail(
        codes, qlens, qg, tg, cnt, rid, seqid, strand, t_base, seq_data,
        seq_offsets, seq_lengths, k=k, q_max=q_max, t_max=t_max, band=band,
        match=match, mismatch=mismatch, gap_open=gap_open,
        gap_extend=gap_extend, min_chain_score=min_chain_score,
        max_per_read=max_per_read, window_pad=window_pad)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.stack([zero, zero, zero, n_keep,
                          torch.tensor(NO_RID, dtype=torch.int32,
                                       device=dev)])
    return torch.cat([out, _pack_counts_row(counts)], dim=0)


def _fused_map_dispatch_devseed(packed2, exc_rid, exc_pos, qlens, keys32,
                                pos_t, ss16, lut2, runcnt, seq_data,
                                seq_offsets, seq_lengths, *, k, w, max_occ,
                                min_group_anchors, gap_break, cap, seq_bits,
                                lut_bits, n_bisect, wtot_max, a_max, g_max,
                                out_cap, q_max, t_max, band, match, mismatch,
                                gap_open, gap_extend, min_chain_score,
                                max_per_read, window_pad):
    """Device-seeded fused map step: only the 2-bit packed reads come from
    the host. The chain's keep set is compacted to out_cap rows before the
    gathers and the banded extension.

    Returns (out_cap+1, FUSED_COLS) int32 rows holding uint16 values, the
    last one the counts row [tot_winners, tot_anchors, n_groups_kept,
    n_keep, min_affected_rid]; rows for reads below min_affected_rid are
    exact, the host redoes the rest."""
    codes = _unpack_reads(packed2, exc_rid, exc_pos)
    qg, tg, cnt, rid, seqid, strand, t_base, dcounts = build_groups_device(
        codes, qlens, keys32, pos_t, ss16, lut2, runcnt, k=k, w=w,
        max_occ=max_occ, min_group_anchors=min_group_anchors,
        gap_break=gap_break, cap=cap, seq_bits=seq_bits, lut_bits=lut_bits,
        n_bisect=n_bisect, wtot_max=wtot_max, a_max=a_max, g_max=g_max)
    out, n_keep, minrid_out = _fused_tail(
        codes, qlens, qg, tg, cnt, rid, seqid, strand, t_base, seq_data,
        seq_offsets, seq_lengths, k=k, q_max=q_max, t_max=t_max, band=band,
        match=match, mismatch=mismatch, gap_open=gap_open,
        gap_extend=gap_extend, min_chain_score=min_chain_score,
        max_per_read=max_per_read, window_pad=window_pad, ext_cap=out_cap)
    minrid = torch.minimum(dcounts[3], minrid_out)
    counts = torch.cat([dcounts[:3], n_keep[None], minrid[None]])
    return torch.cat([out, _pack_counts_row(counts)], dim=0)


def _to_host_u16(rows: torch.Tensor) -> np.ndarray:
    """Device rows (int32 holding uint16 values) -> host uint16 matrix."""
    with span("map.fetch"):
        return rows.cpu().numpy().astype(np.uint16)


def _count_windows(qlens, wlens, rows, q_max, t_max):
    """Counters of an extension batch: its windows, their real bases, and
    the bytes of the padded (rows, q_max) and (rows, t_max) windows the
    device scores."""
    count("windows", len(qlens))
    count("window_bytes", qlens.sum() + wlens.sum())
    count("window_bytes_padded", rows * (q_max + t_max))


# ---------------------------------------------------------------------------
# host part (copies of the TPU package's host helpers)


@dataclass
class AlignParams:
    """map-ont-flavored parameters (minimap2 defaults where applicable).
    The TPU package's `backend` field has no counterpart: the tensors'
    device picks kernel or plain version."""

    match: int = 2
    mismatch: int = 4
    gap_open: int = 4
    gap_extend: int = 2
    band: int | None = None    # None = auto by read length (128/256/512)
    max_occ: int = 64
    max_anchors_per_group: int = 256
    min_group_anchors: int = 3
    min_chain_score: int = 40
    max_alignments_per_read: int = 50   # reference uses -N 50
    secondary_ratio: float = 1.0   # minimap2 -p
    mask_level: float = 0.5        # minimap2 --mask-level
    min_alignment_score: int = 0
    window_pad: int = 64
    gap_break: int = 5000
    extend_batch: int = 1024
    fused_anchor_cap: int = 32   # ragged per-group anchor cap (fused path)
    tiebreaker_seed: int = 0
    fused: bool = True   # PAF mode: single-dispatch map step
    device_seed: bool = True    # seed on device; per-slice partial redo on
    #                             a static-cap overflow (counts row)
    devseed_out_per_read: int = 2   # out_cap = next_pow2(this * slice_n)


@dataclass
class SequenceMeta:
    """Per-target-sequence metadata (assembly + taxonomy join columns)."""

    assembly_idx: np.ndarray   # (n_seqs,) int32 index into assembly_names
    assembly_names: list[str]
    tax_id: np.ndarray = field(default=None)
    species_tax_id: np.ndarray = field(default=None)
    genus_tax_id: np.ndarray = field(default=None)

    @staticmethod
    def single_assembly_per_sequence(seq_names):
        n = len(seq_names)
        return SequenceMeta(
            assembly_idx=np.arange(n, dtype=np.int32),
            assembly_names=list(seq_names),
            tax_id=np.zeros(n, np.int64),
            species_tax_id=np.zeros(n, np.int64),
            genus_tax_id=np.zeros(n, np.int64),
        )


def _pack_reads2(reads: list[np.ndarray], read_max: int,
                 n_rows: int | None = None):
    """Host-side 2-bit packing of a read batch: (n, read_max/4) uint8 plus
    exception lists (rid, pos) for non-ACGT codes. Exception padding rows use
    rid = n_rows (dropped by the device scatter)."""
    n = n_rows if n_rows is not None else len(reads)
    if n < len(reads):
        raise ValueError(f"n_rows={n} < {len(reads)} reads")
    mat = np.zeros((n, read_max), np.uint8)
    exc_r, exc_p = [], []
    for i, r in enumerate(reads):
        mat[i, : len(r)] = r
        bad = np.flatnonzero(r > 3)
        if len(bad):
            exc_r.append(np.full(len(bad), i, np.int32))
            exc_p.append(bad.astype(np.int32))
            mat[i, bad] = 0
    packed2 = (mat[:, 0::4] << 6) | (mat[:, 1::4] << 4) \
        | (mat[:, 2::4] << 2) | mat[:, 3::4]
    ne = sum(len(a) for a in exc_r)
    ep = 64
    while ep < ne:
        ep *= 2
    exc_rid = np.full(ep, n, np.int32)      # out-of-bounds -> dropped
    exc_pos = np.zeros(ep, np.int32)
    if ne:
        exc_rid[:ne] = np.concatenate(exc_r)
        exc_pos[:ne] = np.concatenate(exc_p)
    return packed2, exc_rid, exc_pos


def _pack_seq4(data: np.ndarray) -> np.ndarray:
    """Host-side 4-bit packing of reference codes (values 0..5)."""
    if len(data) % 2:
        data = np.concatenate([data, np.full(1, 5, np.int8)])
    u = data.astype(np.uint8)
    return ((u[0::2] << 4) | u[1::2]).astype(np.uint8)


def _lut_bits_for(n_keys: int, k: int) -> int:
    """LUT sizing policy: ~4 buckets per key, capped at 2**24 entries."""
    return min(2 * k, 24, max(12, int(np.ceil(np.log2(max(n_keys, 2)))) + 2))


def _build_lut(keys: np.ndarray, k: int):
    """Paired bucket LUT for the device hash lookup: row b of lut2 is
    [first index with key-top-bits >= b, same for b+1]."""
    n = len(keys)
    lut_bits = _lut_bits_for(n, k)
    shift = 2 * k - lut_bits
    bounds = (np.arange((1 << lut_bits) + 1, dtype=np.int64) << shift)
    lut = np.searchsorted(keys, bounds).astype(np.int32)
    max_bucket = int(np.diff(lut).max()) if n else 0
    lut2 = np.stack([lut[:-1], lut[1:]], axis=1)
    return lut_bits, np.ascontiguousarray(lut2), \
        max(1, max_bucket.bit_length())


def _run_counts(keys: np.ndarray) -> np.ndarray:
    """uint8 plane: at the FIRST index of each equal-key run, the run length
    clipped to 255 (0 elsewhere)."""
    n = len(keys)
    out = np.zeros(n, np.uint8)
    if n:
        first = np.concatenate([[True], keys[1:] != keys[:-1]])
        starts = np.flatnonzero(first)
        counts = np.diff(np.append(starts, n))
        out[starts] = np.minimum(counts, 255).astype(np.uint8)
    return out


def _stable_uniform(seed: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Deterministic per-row uniform [0,1) from integer keys."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + b.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
         + np.uint64(seed))
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _cigar_stats(cigar, read, ref, read_start, ref_start):
    """matches / edit distance from a CIGAR walk (M runs compared
    base-wise). No map path calls it."""
    m = 0
    nm = 0
    qi, ti = read_start, ref_start
    for length, op in cigar:
        if op == "M":
            a = read[qi: qi + length]
            b = ref[ti: ti + length]
            eq = int(np.sum(a == b))
            m += eq
            nm += length - eq
            qi += length
            ti += length
        elif op == "I":
            nm += length
            qi += length
        elif op == "D":
            nm += length
            ti += length
    return m, nm


def select_alignments(rid, score, q_from, q_to, seq, strand, t_from, t_to,
                      *, secondary_ratio: float = 1.0,
                      mask_level: float = 0.5, max_secondary: int = 50):
    """minimap2-style multi-locus selection (mm_set_parent / mm_select_sub
    semantics on extension scores). Returns (keep_idx, mapq, is_secondary).
    See the TPU package's select_alignments for the full contract."""
    n = len(rid)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(bool)
    order = np.lexsort((np.arange(n), -np.asarray(score),
                        np.asarray(rid)))
    rid_o = np.asarray(rid)[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], rid_o[1:] != rid_o[:-1]]))
    bounds = np.append(starts, n)

    q_from = np.asarray(q_from)
    q_to = np.asarray(q_to)
    t_from = np.asarray(t_from)
    t_to = np.asarray(t_to)
    seq = np.asarray(seq)
    strand = np.asarray(strand)
    score = np.asarray(score)

    def _mapq(f1, f2):
        if f1 <= 0:
            return 0
        return int(min(60, 40.0 * max(0.0, 1.0 - f2 / f1)
                       + 0.01 * min(f1, 2000)))

    # a read with exactly one candidate is primary with f2 = 0
    run_len = np.diff(bounds)
    if (run_len == 1).all():
        idx = order[starts].astype(np.int64)
        f1 = score[idx].astype(np.float64)
        mq = np.where(f1 <= 0, 0.0,
                      np.minimum(60.0, 40.0 + 0.01 * np.minimum(f1, 2000)))
        return idx, mq.astype(np.int64), np.zeros(len(idx), bool)

    single = run_len == 1
    keep_idx: list[int] = []
    mapqs: list[int] = []
    secondary: list[bool] = []

    for b in range(len(starts)):
        cand = order[bounds[b]: bounds[b + 1]]
        if single[b]:
            i = int(cand[0])
            keep_idx.append(i)
            mapqs.append(_mapq(int(score[i]), 0))
            secondary.append(False)
            continue
        primaries: list[int] = []
        prim_f2: list[int] = []
        kept: list[tuple[int, bool, int]] = []
        n_sec = 0
        seen: list[int] = []
        for i in cand:
            i = int(i)
            ql = q_to[i] - q_from[i]
            tl = t_to[i] - t_from[i]
            dup = False
            for j in seen:
                if seq[j] != seq[i] or strand[j] != strand[i]:
                    continue
                qo = min(q_to[i], q_to[j]) - max(q_from[i], q_from[j])
                to = min(t_to[i], t_to[j]) - max(t_from[i], t_from[j])
                if (qo >= 0.5 * min(ql, q_to[j] - q_from[j])
                        and to >= 0.5 * min(tl, t_to[j] - t_from[j])):
                    dup = True
                    break
            if dup:
                continue
            parent = -1
            best_ov = 0.0
            for slot, j in enumerate(primaries):
                qo = min(q_to[i], q_to[j]) - max(q_from[i], q_from[j])
                frac = qo / max(1, min(ql, q_to[j] - q_from[j]))
                if frac > best_ov:
                    best_ov = frac
                    parent = slot
            if best_ov < mask_level:
                primaries.append(i)
                prim_f2.append(0)
                kept.append((i, False, len(primaries) - 1))
                seen.append(i)
            else:
                ps = int(score[primaries[parent]])
                prim_f2[parent] = max(prim_f2[parent], int(score[i]))
                if (score[i] >= secondary_ratio * ps
                        and n_sec < max_secondary):
                    kept.append((i, True, parent))
                    seen.append(i)
                    n_sec += 1
        for i, is_sec, slot in kept:
            keep_idx.append(i)
            mapqs.append(0 if is_sec
                         else _mapq(int(score[i]), prim_f2[slot]))
            secondary.append(is_sec)
    return (np.array(keep_idx, np.int64), np.array(mapqs, np.int64),
            np.array(secondary, bool))


def fused_collect_np(arr_u16, qlens_a, id_base, read_names,
                     params: AlignParams, seq_names: list[str],
                     seq_lengths: np.ndarray, meta: SequenceMeta) -> AlignList:
    """Build align_list rows from downloaded _fused_tail rows (vectorized
    numpy). arr_u16: (rows, FUSED_COLS) uint16, counts row stripped."""
    p = params
    n_seqs = len(seq_names)
    seq_lens = seq_lengths
    arr = arr_u16.astype(np.int64)
    w_lo = arr[:, F_WLO_LO] | (arr[:, F_WLO_HI] << 16)

    kept = np.flatnonzero((arr[:, F_KEEP] == 1)
                          & (arr[:, F_SCORE] > p.min_alignment_score))
    if len(kept) == 0:
        return AlignList.empty(seq_names, meta.assembly_names,
                               read_names or [])
    rid_k = arr[kept, F_RID]
    qlen_k = qlens_a[rid_k].astype(np.int64)
    strand_k = arr[kept, F_STRAND]
    ob_k = arr[kept, F_QS] + arr[kept, F_BEGIN_I]   # oriented frame
    oe_k = arr[kept, F_QS] + arr[kept, F_END_I]
    rf_k = np.where(strand_k == 0, ob_k, qlen_k - (oe_k + 1))
    rt_k = np.where(strand_k == 0, oe_k + 1, qlen_k - ob_k)
    tf_k = w_lo[kept] + arr[kept, F_BEGIN_J]
    tt_k = w_lo[kept] + arr[kept, F_END_J] + 1

    sel, mapq, _is_sec = select_alignments(
        rid_k, arr[kept, F_SCORE], rf_k, rt_k, arr[kept, F_SEQ],
        strand_k, tf_k, tt_k, secondary_ratio=p.secondary_ratio,
        mask_level=p.mask_level,
        max_secondary=p.max_alignments_per_read)
    g = kept[sel]

    rid_s = rid_k[sel]
    seq_s = arr[g, F_SEQ]
    sc_s = arr[g, F_SCORE]
    qlen_s = qlen_k[sel]
    strand_s = strand_k[sel]

    out = np.zeros(len(g), ALIGN_DTYPE)
    out["read_id"] = rid_s + id_base
    out["read_length"] = qlen_s
    out["read_from"] = rf_k[sel]
    out["read_to"] = rt_k[sel]
    out["strand"] = strand_s
    out["sequence_id"] = seq_s
    out["sequence_length"] = seq_lens[seq_s]
    out["sequence_from"] = w_lo[g] + arr[g, F_BEGIN_J]
    out["sequence_to"] = w_lo[g] + arr[g, F_END_J] + 1
    out["match"] = arr[g, F_MATCH]
    out["mapq"] = mapq
    out["edit_dist"] = arr[g, F_EDIT]
    out["alignment_score"] = sc_s
    out["assembly_id"] = meta.assembly_idx[seq_s]
    out["tax_id"] = meta.tax_id[seq_s]
    out["species_tax_id"] = meta.species_tax_id[seq_s]
    out["genus_tax_id"] = meta.genus_tax_id[seq_s]
    out["alignment_score_tiebreaker"] = _stable_uniform(
        p.tiebreaker_seed, out["read_id"],
        out["sequence_id"].astype(np.int64) * np.int64(n_seqs + 1)
        + out["sequence_from"])
    order = np.lexsort((out["sequence_from"], out["sequence_id"],
                        out["read_id"]))
    return AlignList(out[order], list(seq_names),
                     list(meta.assembly_names), read_names or [],
                     None)


def _unpack_counts_row(row_u16):
    """Inverse of _pack_counts_row: (FUSED_COLS,) uint16 -> (5,) int64."""
    r = row_u16.astype(np.int64)
    return r[0:10:2] | (r[1:10:2] << 16)


def _bucket(x, lo=256):
    b = lo
    while b < x:
        b *= 2
    return b


def _round256(x):
    """x rounded up to a multiple of 256, at least 256."""
    return max(-(-x // 256), 1) * 256


@dataclass
class WindowTable:
    """The host path's extension windows as int64 columns, one row a window,
    by read and by falling chain score: the oriented read's query [qs, qe),
    the reference window from w_lo in its sequence (t_start in the
    concatenated reference, t_len long), and the chain's un-padded extents
    [cq_lo, cq_hi) and [ct_lo, ct_hi), which select_alignments reads."""

    rid: np.ndarray
    seq_id: np.ndarray
    strand: np.ndarray
    qlen: np.ndarray
    qs: np.ndarray
    qe: np.ndarray
    w_lo: np.ndarray
    cq_lo: np.ndarray
    cq_hi: np.ndarray
    ct_lo: np.ndarray
    ct_hi: np.ndarray
    t_start: np.ndarray
    t_len: np.ndarray

    def __len__(self) -> int:
        return len(self.rid)

    @property
    def q_len(self) -> np.ndarray:
        return self.qe - self.qs

    def take(self, i) -> WindowTable:
        return WindowTable(*(getattr(self, f.name)[i] for f in fields(self)))


def _window_table(groups, chain, t_base, qlens, seq_offsets, seq_lengths, *,
                  k: int, p: AlignParams) -> WindowTable:
    """The windows of each read's first max_alignments_per_read groups by
    chain score (ties in group order) among those reaching min_chain_score,
    from the chain outputs (score, q_min, q_max, t_min, t_max): each cut
    around its chain so that the diagonal starts near (0, 0), padded by
    window_pad, clamped to read and sequence. The back-shift reads p.band,
    0 under the auto band, as in the reference (`_fused_tail` reads the
    slice's band)."""
    chain = chain.astype(np.int64)
    g = np.flatnonzero(chain[0] >= p.min_chain_score)
    g = g[np.lexsort((-chain[0, g], groups.group_read[g]))]
    rid = groups.group_read[g].astype(np.int64)
    # rank: position minus the start of the read's run (rid is sorted)
    top = np.arange(len(g)) - np.searchsorted(rid, rid) \
        < p.max_alignments_per_read
    g, rid = g[top], rid[top]
    seq_id = groups.group_seq[g].astype(np.int64)
    qlen = qlens[rid]
    seq_len = seq_lengths[seq_id]
    q_lo = chain[1, g] - (k - 1)
    q_hi = chain[2, g] + 1
    t_lo = chain[3, g] + t_base[g] - (k - 1)
    t_hi = chain[4, g] + t_base[g] + 1
    band = p.band if p.band is not None else 0
    dshift = min(band // 8, 64) if band > 128 else 0
    left = np.minimum(q_lo, t_lo) + p.window_pad
    right = np.minimum(qlen - q_hi, seq_len - t_hi) + p.window_pad
    qs = np.maximum(q_lo - left, 0)
    qe = np.minimum(q_hi + right, qlen)
    w_lo = np.maximum(t_lo - (q_lo - qs) - dshift, 0)
    w_hi = np.minimum(t_hi + (qe - q_hi) + dshift, seq_len)
    return WindowTable(
        rid, seq_id, groups.group_strand[g].astype(np.int64), qlen, qs, qe,
        w_lo, np.maximum(q_lo, 0), np.minimum(q_hi, qlen),
        np.maximum(t_lo, 0), np.minimum(t_hi, seq_len),
        seq_offsets[seq_id] + w_lo, w_hi - w_lo)


def _oriented_reads(reads, qlens, win: WindowTable):
    """The reads and their concatenation reverse-complemented once (each
    read's reverse complement, in reverse order) in one int8 buffer, and
    each window's query start in it."""
    off = (np.cumsum(qlens) - qlens)[win.rid]
    fwd = np.concatenate(reads).astype(np.int8, copy=False)
    n = len(fwd)
    q0 = np.where(win.strand == 0, off, 2 * n - off - win.qlen) + win.qs
    return np.concatenate([fwd, revcomp(fwd)]), q0


def require_device(device, owner: str) -> None:
    """Raise if `device` names a CUDA device and none is available: an
    entry point never falls back to the CPU on its own."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device={str(device)!r}): no CUDA device is available; "
            f'pass device="cpu" to run the plain PyTorch versions on the CPU')


class MinimizerAligner:
    """End-to-end read mapper against a MinimizerIndex, on one torch device:
    the GPU unless the caller asks for `device="cpu"` (plain PyTorch versions
    of the kernels)."""

    def __init__(self, index: MinimizerIndex, meta: SequenceMeta | None = None,
                 params: AlignParams | None = None, *, device="cuda"):
        if index.seq_data is None:
            raise ValueError("index must keep target sequences")
        require_device(device, "MinimizerAligner")
        self.index = index
        self.params = params or AlignParams()
        self.meta = meta or SequenceMeta.single_assembly_per_sequence(
            index.seq_names)
        self.device = torch.device(device)
        # device-resident planes (see state.device_planes_from_numpy), lazy
        self._planes: dict[str, torch.Tensor] = {}
        self._lut_meta: tuple[int, int] | None = None   # lut_bits, n_bisect
        # devseed overflow telemetry (partial-redo rate; logged on overflow)
        self.overflow_stats = {"slices": 0, "overflow_slices": 0,
                               "reads_redone": 0}
        # adaptive static-cap scales, raised by _devseed_cutoff on overflow
        self._cap_scales = {"w": 1.0, "a": 1.0, "g": 1.0, "out": 1.0}

    def _band_for(self, qm: int) -> int:
        if self.params.band is not None:
            return self.params.band
        return 128 if qm <= 2048 else (256 if qm <= 8192 else 512)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _device_refs(self) -> torch.Tensor:
        """The device-resident 4-bit packed reference, with a 2**15
        sentinel tail so windows never shift (uploaded once)."""
        if "seq4" not in self._planes:
            pad = np.full(2 ** 15, 5, np.int8)
            data = np.concatenate([self.index.seq_data, pad])
            self._planes.update(device_planes_from_numpy(
                {"seq4": _pack_seq4(data)}, device=self.device))
        return self._planes["seq4"]

    def _device_index_meta(self):
        """Device-resident seq_offsets / seq_lengths (int32, lazy)."""
        if "seq_offsets" not in self._planes:
            self._planes.update(device_planes_from_numpy(
                {"seq_offsets": self.index.seq_offsets.astype(np.int32),
                 "seq_lengths": self.index.seq_lengths.astype(np.int32)},
                device=self.device))
        return self._planes["seq_offsets"], self._planes["seq_lengths"]

    def _seq_bits(self) -> int:
        n_seqs = len(self.index.seq_names)
        return max(1, (max(n_seqs - 1, 1)).bit_length())

    def _device_index_planes(self):
        """Device-resident index planes for device seeding: keys32, pos_t,
        ss16 (int32 on the device), the paired bucket LUT lut2, runcnt, and
        the static (lut_bits, n_bisect). Uploaded once (lazy)."""
        if self._lut_meta is None:
            idx = self.index
            if idx.k > 15:
                raise ValueError("device seeding requires k <= 15")
            seq_id, pos, strand = idx.unpack(idx.positions)
            keys = idx.keys.astype(np.int64)
            if keys.size and keys.max() >= 2 ** 30:
                raise ValueError("device seeding requires hashes < 2**30")
            lut_bits, lut2, n_bisect = _build_lut(keys, idx.k)
            self._planes.update(device_planes_from_numpy({
                "keys32": keys.astype(np.int32),
                "pos_t": pos.astype(np.int32),
                "ss16": ((seq_id.astype(np.int32) << 1)
                         | strand).astype(np.uint16),
                "lut2": lut2,
                "runcnt": _run_counts(keys)}, device=self.device))
            self._lut_meta = (lut_bits, n_bisect)
        pl = self._planes
        return (pl["keys32"], pl["pos_t"], pl["ss16"], pl["lut2"],
                pl["runcnt"]) + self._lut_meta

    def _devseed_ok(self, slice_n: int) -> bool:
        """Gate for the device-seeded fused path (all exactness-critical)."""
        p = self.params
        idx = self.index
        n_seqs = len(idx.seq_names)
        return (p.device_seed and idx.k <= 15 and len(idx.keys) > 0
                and 0 < n_seqs < 2 ** 15
                and slice_n < 2 ** 16
                and p.max_occ < 255          # runcnt plane is uint8-clipped
                and slice_n * (1 << (self._seq_bits() + 1)) < 2 ** 31 - 1
                and idx.seq_data.size < 2 ** 31 - 2 ** 16)

    @staticmethod
    def _devseed_caps(slice_n: int, read_max: int, occ: float = 0.0):
        """Static shape caps for the device-seeded dispatch (winner slots,
        anchor slots, candidate groups); overflow is redone exactly."""
        wtot_max = _bucket(slice_n * read_max // 4, lo=4096)
        frac = min(0.5 + 2.0 * occ, 4.0)
        gran = max(wtot_max // 16, 4096)
        a_max = -(-int(wtot_max * frac) // gran) * gran
        g_max = _bucket(2 * slice_n, lo=4096)
        return wtot_max, a_max, g_max

    def _index_occupancy(self) -> float:
        """Expected spurious table hits per query hash: positions / 4^k."""
        idx = self.index
        return float(idx.positions.size) / float(4 ** idx.k)

    def _finish_fused(self, reads, read_names, id_base, read_max):
        """PAF-mode tail of the map step: one fused dispatch + one download.
        Device-seeded when eligible, host-seeded otherwise; on a device cap
        overflow only the affected read-id suffix re-runs host-seeded."""
        slice_n = _bucket(len(reads), lo=256)
        if self._devseed_ok(slice_n):
            fut, ctx = self._fused_submit_devseed(reads, slice_n, read_max)
            blk = _to_host_u16(fut)
            stats, counts = blk[:-1], _unpack_counts_row(blk[-1])
            cutoff = self._devseed_cutoff(counts, len(reads), ctx[1])
            if cutoff == len(reads):
                return self._fused_collect_np(stats, ctx[0], id_base,
                                              read_names)
            parts = []
            if cutoff > 0:
                kept = stats[stats[:, F_RID].astype(np.int64) < cutoff]
                parts.append(self._fused_collect_np(kept, ctx[0], id_base,
                                                    None))
            parts.append(self._host_seeded_fused(
                reads[cutoff:], id_base + cutoff, read_max))
            return self._concat_parts(parts, read_names)
        return self._host_seeded_fused(reads, id_base, read_max,
                                       read_names=read_names)

    def _host_seeded_fused(self, reads, id_base, read_max, read_names=None):
        """Exact host-seeded fused dispatch for a read list (full slice or a
        partial-redo suffix)."""
        if not reads:
            return AlignList.empty(self.index.seq_names,
                                   self.meta.assembly_names, read_names or [])
        groups = self._seed(reads)
        if groups.n_groups == 0:
            return AlignList.empty(self.index.seq_names,
                                   self.meta.assembly_names, read_names or [])
        fut, ctx = self._fused_submit(reads, groups, read_max,
                                      n_rows=_bucket(len(reads), lo=256))
        blk = _to_host_u16(fut)
        return self._fused_collect_np(blk[:-1], ctx[0], id_base, read_names)

    def _concat_parts(self, parts, read_names, emit_cigars=False):
        """One AlignList from per-slice (or partial-redo) parts, sorted by
        (read, sequence, position); with emit_cigars their cigar_maps are
        merged (read ids are global, so the keys do not collide)."""
        with span("map.concat"):
            datas = [al.data for al in parts if len(al)]
            if not datas:
                return AlignList.empty(self.index.seq_names,
                                       self.meta.assembly_names,
                                       read_names or [])
            cigar_map: dict | None = None
            if emit_cigars:
                cigar_map = {}
                for al in parts:
                    if len(al):
                        cigar_map.update(al.cigar_map or {})
            data = np.concatenate(datas)
            order = np.lexsort((data["sequence_from"], data["sequence_id"],
                                data["read_id"]))
            return AlignList(data[order], list(self.index.seq_names),
                             list(self.meta.assembly_names), read_names or [],
                             cigar_map)

    def _devseed_cutoff(self, counts: np.ndarray, n_reads: int,
                        caps=None) -> int:
        """First read id whose device-seeded candidates were cut by a static
        cap (== n_reads when nothing overflowed). Accumulates the overflow
        telemetry and raises an overflowed cap's scale (20% headroom,
        bounded 8x) for later slices."""
        cutoff = min(int(counts[4]), n_reads)
        st = self.overflow_stats
        st["slices"] += 1
        if cutoff < n_reads:
            st["overflow_slices"] += 1
            st["reads_redone"] += n_reads - cutoff
            count("redo_reads", n_reads - cutoff)
            if caps is not None:
                wtot_max, a_max, g_max, out_cap = caps
                sc = self._cap_scales
                for key, seen, cap in (("w", counts[0], wtot_max),
                                       ("a", counts[1], a_max),
                                       ("g", counts[2], g_max),
                                       ("out", counts[3], out_cap)):
                    if seen > cap:
                        sc[key] = min(8.0, sc[key] * max(
                            1.25, 1.2 * float(seen) / float(cap)))
            logging.getLogger("megapath_nano_tpu_torch.align").info(
                "devseed cap overflow: redoing %d/%d reads host-seeded "
                "(counts=%s; scales now %s; %d/%d slices overflowed)",
                n_reads - cutoff, n_reads, counts[:4].tolist(),
                self._cap_scales, st["overflow_slices"], st["slices"])
        return cutoff

    def _caps_scaled(self, slice_n: int, read_max: int):
        """The static density model x the learned per-cap scale factors."""
        wtot_max, a_max, g_max = self._devseed_caps(
            slice_n, read_max, self._index_occupancy())
        sc = self._cap_scales
        if sc["w"] > 1.0:
            wtot_max = _bucket(int(wtot_max * sc["w"]), wtot_max)
        if sc["a"] > 1.0:
            gran = max(wtot_max // 16, 4096)
            a_max = -(-int(a_max * sc["a"]) // gran) * gran
        if sc["g"] > 1.0:
            g_max = _bucket(int(g_max * sc["g"]), g_max)
        return wtot_max, a_max, g_max

    def _ext_shape(self, read_max: int):
        """(q_max, t_max, band) of the extension: t_max is a multiple of 256
        (the kernel never reaches past q_max + band/2)."""
        band = self._band_for(read_max)
        return read_max, -(-(read_max + band) // 256) * 256, band

    def _fused_submit_devseed(self, reads, slice_n, read_max):
        """Pack + device-seeded dispatch for one slice (padded to slice_n
        rows). Returns (device rows, ctx) with ctx = (qlens, caps); the
        dispatch is asynchronous on a CUDA device."""
        with span("map.submit"):
            p = self.params
            idx = self.index
            seq_off, seq_len = self._device_index_meta()
            keys32, pos_t, ss16, lut2, runcnt, lut_bits, n_bisect = \
                self._device_index_planes()

            packed2, exc_rid, exc_pos = _pack_reads2(reads, read_max,
                                                     n_rows=slice_n)
            qlens_a = np.zeros(slice_n, np.int32)
            qlens_a[:len(reads)] = [len(r) for r in reads]

            wtot_max, a_max, g_max = self._caps_scaled(slice_n, read_max)
            out_cap = 2048
            while out_cap < (p.devseed_out_per_read * self._cap_scales["out"]
                             * slice_n):
                out_cap *= 2
            out_cap = min(out_cap, g_max)
            q_max, t_max, band = self._ext_shape(read_max)
            up = self._upload
            fut = _fused_map_dispatch_devseed(
                up(packed2), up(exc_rid), up(exc_pos), up(qlens_a), keys32,
                pos_t, ss16, lut2, runcnt, self._device_refs(), seq_off,
                seq_len, k=idx.k, w=idx.w, max_occ=p.max_occ,
                min_group_anchors=p.min_group_anchors, gap_break=p.gap_break,
                cap=p.fused_anchor_cap, seq_bits=self._seq_bits(),
                lut_bits=lut_bits, n_bisect=n_bisect, wtot_max=wtot_max,
                a_max=a_max, g_max=g_max, out_cap=out_cap, q_max=q_max,
                t_max=t_max, band=band, match=p.match, mismatch=p.mismatch,
                gap_open=p.gap_open, gap_extend=p.gap_extend,
                min_chain_score=p.min_chain_score,
                max_per_read=p.max_alignments_per_read,
                window_pad=p.window_pad)
            return fut, (qlens_a, (wtot_max, a_max, g_max, out_cap))

    def _fused_submit(self, reads, groups, read_max, n_rows=None):
        """Host pack + host-seeded dispatch for one slice. Returns (device
        rows, ctx) with ctx = (qlens, None). n_rows pads the read matrix."""
        with span("map.submit"):
            p = self.params
            idx = self.index
            seq_off, seq_len = self._device_index_meta()

            cap = p.fused_anchor_cap
            flat_q, flat_t, cnt, t_base = pack_groups_flat(groups, cap=cap)
            ng = len(cnt)
            gp = ((ng + 4095) // 4096) * 4096
            gmeta = np.zeros((5, gp), np.int32)
            gmeta[0, :ng] = groups.group_read
            gmeta[1, :ng] = groups.group_seq
            gmeta[2, :ng] = groups.group_strand
            gmeta[3, :ng] = t_base
            gmeta[4, :ng] = cnt
            na = len(flat_q)
            ap = 4096
            while ap < na:
                ap *= 2
            fq = np.zeros(ap, flat_q.dtype)
            ft = np.zeros(ap, flat_t.dtype)
            fq[:na] = flat_q
            ft[:na] = flat_t
            packed2, exc_rid, exc_pos = _pack_reads2(reads, read_max,
                                                     n_rows=n_rows)
            qlens_a = np.zeros(n_rows or len(reads), np.int32)
            qlens_a[:len(reads)] = [len(r) for r in reads]
            q_max, t_max, band = self._ext_shape(read_max)
            up = self._upload
            fut = _fused_map_dispatch(
                up(packed2), up(exc_rid), up(exc_pos), up(qlens_a), up(fq),
                up(ft), up(gmeta), self._device_refs(), seq_off, seq_len,
                k=idx.k, a_bucket=cap, q_max=q_max, t_max=t_max, band=band,
                match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                gap_extend=p.gap_extend, min_chain_score=p.min_chain_score,
                max_per_read=p.max_alignments_per_read,
                window_pad=p.window_pad)
            return fut, (qlens_a, None)

    def _fused_collect_np(self, arr_u16, qlens_a, id_base, read_names):
        with span("map.collect"):
            return fused_collect_np(
                arr_u16, qlens_a, id_base, read_names, self.params,
                list(self.index.seq_names), self.index.seq_lengths, self.meta)

    def _seed(self, reads):
        """Host seeding of a read list (`collect_anchors`)."""
        p = self.params
        with span("map.seed"):
            return collect_anchors(self.index, reads, max_occ=p.max_occ,
                                   min_group_anchors=p.min_group_anchors,
                                   gap_break=p.gap_break)

    def _fits_fused(self, read_max: int) -> bool:
        """The fused gate's length condition, on a read matrix of read_max
        columns."""
        return read_max + self._band_for(read_max) < 2 ** 15

    def _fused_ok(self, read_max: int, n_reads: int) -> bool:
        """The fused gate: rid/seq_id ride uint16 columns and the per-read
        rank key is rid*2**15 + score in int32."""
        return (self.params.fused
                and self._fits_fused(read_max)
                and n_reads < 2 ** 16
                and len(self.index.seq_names) < 2 ** 16
                and self.index.seq_data.size < 2 ** 31 - 2 ** 16)

    def map_reads(self, reads: list[np.ndarray],
                  read_names: list[str] | None = None,
                  slice_size: int | None = None,
                  emit_cigars: bool = True) -> AlignList:
        """Map reads. With slice_size set and more reads than that, the
        reads go slice by slice: in PAF mode inside the fused gate as waves
        of asynchronous dispatches, else on two worker threads, so that one
        slice's host work (anchor collection, native traceback, both of
        which release the GIL) overlaps the other's device DP.

        emit_cigars=False skips the host traceback: all alignment fields
        (begin/end/match/edit/score) come from the full-stats device kernel
        and cigar_map is None, the PAF-level mode (minimap2 without -a).
        Consumers that need base-level CIGARs (SAM output, AMR consensus,
        variant candidates) map with emit_cigars=True."""
        with span("map.call"):
            if not emit_cigars:
                # before any worker thread: the lazy planes dict is not safe
                # to fill from two threads
                self._device_refs()
                self._device_index_meta()
            if slice_size and len(reads) > slice_size:
                return self._map_reads_pipelined(reads, read_names,
                                                 slice_size, emit_cigars)
            return self._map_slice(reads, read_names, 0, emit_cigars)

    def _map_reads_pipelined(self, reads, read_names, slice_size,
                             emit_cigars=True):
        read_max = _bucket(max(len(r) for r in reads))
        if not emit_cigars and self._fused_ok(read_max, slice_size):
            parts = self._map_slices_async(reads, slice_size, read_max)
        else:
            # each slice runs in a copy of this thread's context, so that
            # its spans are children of this call's
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = [ex.submit(contextvars.copy_context().run,
                                  self._map_slice, reads[s: s + slice_size],
                                  None, s, emit_cigars)
                        for s in range(0, len(reads), slice_size)]
                parts = [f.result() for f in futs]
        return self._concat_parts(parts, read_names, emit_cigars)

    def _map_slices_async(self, reads, slice_size, read_max):
        """Slices in waves: every slice's dispatch is submitted back to back
        (CUDA work is asynchronous, so the host packs slice i+1 while the
        device runs slice i), then a wave's result rows are concatenated on
        the device and fetched in one transfer. A slice whose counts row
        shows a cap overflow defers its affected read-id suffix to trailing
        host-seeded waves (partial redo)."""
        use_dev = self._devseed_ok(slice_size)
        slices = [(s, reads[s: s + slice_size])
                  for s in range(0, len(reads), slice_size)]
        parts = []
        overflowed = []   # (id_base, reads) partial-redo suffixes
        WAVE = 16
        for w0 in range(0, len(slices), WAVE):
            subs = []
            for s, sl in slices[w0: w0 + WAVE]:
                if use_dev:
                    fut, ctx = self._fused_submit_devseed(sl, slice_size,
                                                          read_max)
                else:
                    groups = self._seed(sl)
                    if groups.n_groups == 0:
                        continue
                    fut, ctx = self._fused_submit(sl, groups, read_max)
                subs.append((s, sl, fut, ctx))
            if not subs:
                continue
            big = _to_host_u16(torch.cat([f for _, _, f, _ in subs]))
            off = 0
            for s, sl, fut, ctx in subs:
                blk = big[off: off + fut.shape[0]]
                off += fut.shape[0]
                stats, counts = blk[:-1], _unpack_counts_row(blk[-1])
                if use_dev:
                    cutoff = self._devseed_cutoff(counts, len(sl), ctx[1])
                    if cutoff < len(sl):
                        overflowed.append((s + cutoff, sl[cutoff:]))
                        if cutoff == 0:
                            continue
                        stats = stats[
                            stats[:, F_RID].astype(np.int64) < cutoff]
                parts.append(self._fused_collect_np(stats, ctx[0], s, None))
        # trailing host-seeded waves for devseed partial redos (exact path)
        for w0 in range(0, len(overflowed), WAVE):
            subs = []
            for s, sl in overflowed[w0: w0 + WAVE]:
                groups = self._seed(sl)
                if groups.n_groups == 0:
                    continue
                fut, ctx = self._fused_submit(sl, groups, read_max,
                                              n_rows=_bucket(len(sl)))
                subs.append((s, fut, ctx))
            if not subs:
                continue
            big = _to_host_u16(torch.cat([f for _, f, _ in subs]))
            off = 0
            for s, fut, ctx in subs:
                blk = big[off: off + fut.shape[0]]
                off += fut.shape[0]
                parts.append(self._fused_collect_np(blk[:-1], ctx[0], s,
                                                    None))
        return parts

    def _map_slice(self, reads, read_names, id_base, emit_cigars):
        """One slice under its span: the fused gate sends it to
        `_finish_fused`, anything else to the host path."""
        with span("map.slice"):
            count("reads", len(reads))
            read_max = _bucket(max(len(r) for r in reads))
            if not emit_cigars and self._fused_ok(read_max, len(reads)):
                return self._finish_fused(reads, read_names, id_base,
                                          read_max)
            return self._map_host(reads, read_names, id_base, emit_cigars,
                                  read_max)

    def _map_host(self, reads, read_names, id_base, emit_cigars, read_max):
        """The host-chained path: seed, chain, windows, extend, select,
        traceback (score-only branch), emit; each stage under its span."""
        count("host_path", 1)
        count("long_reads", sum(not self._fits_fused(_bucket(len(r)))
                                for r in reads))
        empty = AlignList.empty(self.index.seq_names,
                                self.meta.assembly_names, read_names or [])
        groups = self._seed(reads)
        if groups.n_groups == 0:
            return empty
        chain, t_base = self._chain(groups)
        with span("map.windows"):
            qlens = np.array([len(r) for r in reads], np.int64)
            win = _window_table(groups, chain, t_base, qlens,
                                self.index.seq_offsets, self.index.seq_lengths,
                                k=self.index.k, p=self.params)
            if len(win) == 0:
                return empty
            # shapes bucketed to powers of two as in the reference; the
            # full-stats kernel (PAF mode) needs windows < 2**15 for its
            # packed companions, beyond that the host traces back
            q_max = _bucket(int(win.q_len.max()))
            t_max = _bucket(max(int(win.t_len.max()), q_max))
            band = self._band_for(q_max)
            full_ok = (not emit_cigars and q_max + band < 2 ** 15
                       and max(t_max, q_max) + band < 2 ** 15)
            if not full_ok:
                qbuf, q0 = _oriented_reads(reads, qlens, win)
        if full_ok:
            full = self._extend_full(reads, qlens, read_max, win, q_max,
                                     t_max, band)
            scores = full[:, F_SCORE]
        else:
            scores = self._extend_scores(win, qbuf, q0, band)
        kept, mapq = self._select(win, scores)
        if len(kept) == 0:
            return empty
        win = win.take(kept)
        if full_ok:
            stats, cigars = full[kept], None
        else:
            stats, cigars = self._traceback(win, qbuf, q0[kept],
                                            scores[kept], band)
        return self._emit(win, stats, mapq, cigars if emit_cigars else None,
                          id_base, read_names)

    def _chain(self, groups):
        """map.chain, then map.fetch: the groups, padded once to 4096-row
        chunks, a launch a chunk; one fetch. Returns the (5, n_groups) chain
        outputs and each group's t_base."""
        CHUNK = 4096
        with span("map.chain"):
            # anchors: the power of two from 32 covering the largest group
            a_bucket = _bucket(min(int(np.diff(groups.group_offsets).max()),
                                   self.params.max_anchors_per_group), lo=32)
            qg, tg, cnt, t_base, _sel = pack_groups(groups,
                                                    max_anchors=a_bucket)
            ng = len(cnt)
            rows = ((0, -ng % CHUNK), (0, 0))
            qg, tg, cnt = (np.pad(x, rows[:x.ndim]) for x in (qg, tg, cnt))
            up = self._upload
            outs = [chain_and_extents(up(qg[c: c + CHUNK]),
                                      up(tg[c: c + CHUNK]),
                                      up(cnt[c: c + CHUNK]))
                    for c in range(0, ng, CHUNK)]
        with span("map.fetch"):
            return torch.cat(outs, dim=1).cpu().numpy()[:, :ng], t_base

    def _extend_full(self, reads, qlens, read_max, win, q_max, t_max, band):
        """map.extend, then map.fetch, PAF mode: one full-stats dispatch,
        which gathers the windows on the device. Returns (n, 7) rows in
        banded_sw_full's column order (F_SCORE .. F_BEGIN_J)."""
        p = self.params
        n = len(win)
        mp = -(-n // 1024) * 1024
        up = self._upload
        with span("map.extend"):
            _count_windows(win.q_len, win.t_len, mp, q_max, t_max)
            packed2, exc_rid, exc_pos = _pack_reads2(reads, read_max)
            meta = np.zeros((6, mp), np.int32)
            meta[:, :n] = (win.rid, win.qs, win.q_len, win.strand,
                           win.t_start, win.t_len)
            full = _extend_full_dispatch(
                up(packed2), up(exc_rid), up(exc_pos),
                up(qlens.astype(np.int32)), up(meta),
                self._device_refs(), q_max=q_max, t_max=t_max, band=band,
                match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                gap_extend=p.gap_extend)
        with span("map.fetch"):
            return full[:n].cpu().numpy().astype(np.int64)

    def _extend_scores(self, win, qbuf, q0, band):
        """map.extend, then map.fetch, score only. A launch lasts as long as
        its longest window (a warp a pair, all resident at once), so the
        windows go out longest first, extend_batch a launch, each launch
        padded to its own longest query and ref. Returns the scores."""
        p = self.params
        ql, t0, tl = win.q_len, win.t_start, win.t_len
        refs = self.index.seq_data
        up = self._upload
        with span("map.extend"):
            order = np.argsort(-ql, kind="stable")
            parts = []
            for s0 in range(0, len(win), p.extend_batch):
                part = order[s0: s0 + p.extend_batch]
                m = len(part)
                q_top = int(ql[part[0]])
                q_l = _round256(q_top)
                t_l = max(_round256(int(tl[part].max())), q_l)
                ra = np.full((m, q_l), 4, np.int8)
                ta = np.full((m, t_l), 5, np.int8)
                for row, (a, n, b, L) in enumerate(zip(
                        q0[part].tolist(), ql[part].tolist(),
                        t0[part].tolist(), tl[part].tolist())):
                    ra[row, :n] = qbuf[a: a + n]
                    ta[row, :L] = refs[b: b + L]
                sc, _, _ = banded_sw_scores(
                    up(ra), up(ql[part].astype(np.int32)), up(ta),
                    up(tl[part].astype(np.int32)), band=band,
                    match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                    gap_extend=p.gap_extend)
                parts.append(sc)
                _count_windows(ql[part], tl[part], m, q_l, t_l)
                count("ext_rows_launched", m * q_top)
            count("ext_rows", ql.sum())
        with span("map.fetch"):
            scores = np.empty(len(win), np.int64)
            scores[order] = torch.cat(parts).cpu().numpy()
            return scores

    def _select(self, win, scores):
        """map.select: minimap2-style multi-locus selection (-N / -p) of the
        windows above min_alignment_score. Returns kept indices, mapq."""
        p = self.params
        with span("map.select"):
            ok = np.flatnonzero(scores > p.min_alignment_score)
            w = win.take(ok)
            plus = w.strand == 0
            sel, mapq, _is_sec = select_alignments(
                w.rid, scores[ok], np.where(plus, w.cq_lo, w.qlen - w.cq_hi),
                np.where(plus, w.cq_hi, w.qlen - w.cq_lo), w.seq_id, w.strand,
                w.ct_lo, w.ct_hi, secondary_ratio=p.secondary_ratio,
                mask_level=p.mask_level,
                max_secondary=p.max_alignments_per_read)
            return ok[sel], mapq

    def _traceback(self, win, qbuf, q0, scores, band):
        """map.traceback by the native banded aligner, at half the band first
        (2x cheaper); a pair whose score misses the device's is redone at the
        full band, so the result is exact. Returns (n, 7) rows in
        banded_sw_full's column order, and the CIGARs."""
        p = self.params
        refs = self.index.seq_data
        kw = dict(match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                  gap_extend=p.gap_extend)
        with span("map.traceback"):
            qw = [qbuf[a: a + n]
                  for a, n in zip(q0.tolist(), win.q_len.tolist())]
            tw = [refs[b: b + L]
                  for b, L in zip(win.t_start.tolist(), win.t_len.tolist())]
            alns = banded_align_batch(qw, tw, band=max(64, band // 2), **kw)
            redo = [r for r, a in enumerate(alns) if a.score != scores[r]]
            if redo:
                fixed = banded_align_batch([qw[r] for r in redo],
                                           [tw[r] for r in redo], band=band,
                                           **kw)
                for r, a in zip(redo, fixed):
                    alns[r] = a
            count("traceback_pairs", len(alns))
            count("traceback_redo", len(redo))
            stats = np.array([(a.score, a.read_end, a.ref_end, a.n_match,
                               a.edit_dist, a.read_begin, a.ref_begin)
                              for a in alns], np.int64)
            return stats, [a.cigar for a in alns]

    def _emit(self, win, stats, mapq, cigars, id_base, read_names):
        """map.emit: the kept windows' AlignList, sorted by (read, sequence,
        position). With cigars, every locus is addressable in cigar_map by
        (rid, sid, seq_from); the first strictly best locus of a (rid, sid)
        also owns the 2-key that variant/ and amr/consensus read."""
        meta = self.meta
        sid = win.seq_id
        with span("map.emit"):
            ob = win.qs + stats[:, F_BEGIN_I]      # oriented-frame begin/end
            oe = win.qs + stats[:, F_END_I]
            plus = win.strand == 0
            out = np.zeros(len(win), ALIGN_DTYPE)
            out["read_id"] = win.rid + id_base
            out["read_length"] = win.qlen
            out["read_from"] = np.where(plus, ob, win.qlen - (oe + 1))
            out["read_to"] = np.where(plus, oe + 1, win.qlen - ob)
            out["strand"] = win.strand
            out["sequence_id"] = sid
            out["sequence_length"] = self.index.seq_lengths[sid]
            out["sequence_from"] = win.w_lo + stats[:, F_BEGIN_J]
            out["sequence_to"] = win.w_lo + stats[:, F_END_J] + 1
            out["match"] = stats[:, F_MATCH]
            out["mapq"] = mapq
            out["edit_dist"] = stats[:, F_EDIT]
            out["alignment_score"] = stats[:, F_SCORE]
            out["assembly_id"] = meta.assembly_idx[sid]
            out["tax_id"] = meta.tax_id[sid]
            out["species_tax_id"] = meta.species_tax_id[sid]
            out["genus_tax_id"] = meta.genus_tax_id[sid]
            out["alignment_score_tiebreaker"] = _stable_uniform(
                self.params.tiebreaker_seed, out["read_id"],
                out["sequence_id"].astype(np.int64)
                * np.int64(len(self.index.seq_names) + 1)
                + out["sequence_from"])
            cigar_map: dict | None = None
            if cigars is not None:
                cigar_map, best = {}, {}
                for rid, s, sf, score, entry in zip(
                        out["read_id"].tolist(), sid.tolist(),
                        out["sequence_from"].tolist(),
                        out["alignment_score"].tolist(),
                        zip(cigars, ob.tolist(), win.strand.tolist())):
                    cigar_map[(rid, s, sf)] = entry
                    if score > best.get((rid, s), -1):
                        best[(rid, s)] = score
                        cigar_map[(rid, s)] = entry
            order = np.lexsort((out["sequence_from"], out["sequence_id"],
                                out["read_id"]))
            return AlignList(out[order], list(self.index.seq_names),
                             list(meta.assembly_names), read_names or [],
                             cigar_map)

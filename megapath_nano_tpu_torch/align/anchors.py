"""Seed lookup and anchor grouping (host side, vectorized numpy).

Replaces minimap2's seed-collection phase (the reference shells out to
minimap2, reference: bin/lib/aligner.py:206-217). Lookup against the sorted
minimizer table is one native call (sketch, LUT lookup, hit expansion, sort).
The port's own copy of megapath_nano_tpu/align/anchors.py.

Anchors are (q_end, t_end) k-mer end-position pairs per (sequence, strand)
group, with reverse-strand query coordinates flipped so chains are colinear
ascending in both coordinates — minimap2's coordinate convention.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex


@dataclass
class AnchorGroups:
    """Flat anchor arrays partitioned into candidate groups.

    Each group = anchors of one (read, target sequence, strand) candidate,
    sorted by (t_end, q_end). group_offsets has n_groups+1 entries into the
    flat arrays; group_read/seq/strand give each group's identity.
    """

    q_end: np.ndarray      # (total_anchors,) int32 (strand-adjusted)
    t_end: np.ndarray      # (total_anchors,) int64
    group_offsets: np.ndarray  # (n_groups+1,) int64
    group_read: np.ndarray     # (n_groups,) int32
    group_seq: np.ndarray      # (n_groups,) int32
    group_strand: np.ndarray   # (n_groups,) int8

    @property
    def n_groups(self) -> int:
        return len(self.group_read)


def collect_anchors(
    index: MinimizerIndex,
    reads: list[np.ndarray],
    *,
    max_occ: int = 64,
    min_group_anchors: int = 3,
    gap_break: int = 5000,
) -> AnchorGroups:
    """Sketch reads, look up each minimizer, and group hits.

    max_occ: minimizers occurring more than this in the index are skipped
    (repeat masking — minimap2's mid-occurrence filter).
    gap_break: split a (read, seq, strand) group at target gaps larger than
    this — the chain DP can't link across them (max_dist), and smaller
    groups keep the packed anchor arrays dense and int16-safe.
    """
    empty = AnchorGroups(np.zeros(0, np.int32), np.zeros(0, np.int64),
                         np.zeros(1, np.int64), np.zeros(0, np.int32),
                         np.zeros(0, np.int32), np.zeros(0, np.int8))
    if not reads:
        return empty

    # ONE native call: sketch → LUT lookup → hit expansion (max_occ repeat
    # masking) → per-read sort. Output arrives ordered by
    # (read, seq, strand, t, q) with no global lexsort.
    import os

    n = len(reads)
    flat = np.concatenate([np.asarray(r, np.int8) for r in reads])
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offsets[1:])
    q, t, seq, strand, roffs = index.anchor_arrays(
        flat, offsets, max_occ=max_occ,
        n_threads=min(os.cpu_count() or 1, 8))
    if len(q) == 0:
        return empty
    rid = np.repeat(np.arange(n, dtype=np.int32), np.diff(roffs))

    new_group = np.empty(len(q), bool)
    new_group[0] = True
    new_group[1:] = (rid[1:] != rid[:-1]) | (seq[1:] != seq[:-1]) \
        | (strand[1:] != strand[:-1]) | (t[1:] - t[:-1] > gap_break)
    group_starts = np.flatnonzero(new_group)
    group_ends = np.append(group_starts[1:], len(q))
    sizes_all = group_ends - group_starts
    keep = sizes_all >= min_group_anchors
    group_starts, group_ends = group_starts[keep], group_ends[keep]

    # compact the kept groups (rows are contiguous per group)
    keep_row = np.repeat(keep, sizes_all)
    idx = np.flatnonzero(keep_row)
    sizes = group_ends - group_starts
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return AnchorGroups(
        q_end=q[idx], t_end=t[idx],
        group_offsets=offsets,
        group_read=rid[group_starts],
        group_seq=seq[group_starts],
        group_strand=strand[group_starts],
    )


def pack_groups_flat(groups: AnchorGroups, *, cap: int = 32):
    """Ragged (flat) packing of anchor groups for the fused device path.

    Each group keeps at most `cap` anchors, subsampled evenly (first and last
    always kept, so chain extents are preserved). Returns
    (flat_q, flat_t, cnt, t_base): flat int16/int32 coordinate arrays of
    total length cnt.sum(), per-group counts, and per-group target bases.
    The device dispatch rebuilds the padded (n_groups, cap) matrices with a
    gather, so only the ragged data is uploaded. Fully vectorized (no
    per-group Python loop).
    """
    n = groups.n_groups
    if n == 0:
        z16 = np.zeros(0, np.int16)
        return z16, z16, np.zeros(0, np.int32), np.zeros(0, np.int64)
    sizes = np.diff(groups.group_offsets).astype(np.int64)
    m = np.minimum(sizes, cap)
    total = int(m.sum())
    starts0 = np.concatenate([[0], np.cumsum(m)[:-1]])
    j = np.arange(total, dtype=np.int64) - np.repeat(starts0, m)
    s_rep = np.repeat(groups.group_offsets[:-1], m)
    size_rep = np.repeat(sizes, m)
    m_rep = np.repeat(m, m)
    # even subsample: j * (size-1) // (m-1); keeps endpoints exactly
    pick = s_rep + np.where(m_rep > 1,
                            j * (size_rep - 1) // np.maximum(m_rep - 1, 1),
                            0)
    t_base = groups.t_end[groups.group_offsets[:-1]]
    flat_q = groups.q_end[pick].astype(np.int32)
    flat_t = (groups.t_end[pick] - np.repeat(t_base, m)).astype(np.int32)
    if total == 0 or (flat_q.max() < 2 ** 15 and flat_t.max() < 2 ** 15
                      and flat_q.min() >= 0):
        flat_q = flat_q.astype(np.int16)
        flat_t = flat_t.astype(np.int16)
    return flat_q, flat_t, m.astype(np.int32), t_base


def pack_groups(groups: AnchorGroups, *, max_anchors: int = 256):
    """Pad groups into fixed (n_groups, max_anchors) arrays for the device
    chaining kernel. Oversize groups are subsampled evenly (keeps chain
    structure; exact minimap2 would RMQ-chain all anchors).

    Emits int16 coordinate arrays when every value fits (the common case
    after gap_break splitting), which halves the host→device upload."""
    n = groups.n_groups
    q = np.zeros((n, max_anchors), np.int32)
    t = np.zeros((n, max_anchors), np.int32)
    cnt = np.zeros(n, np.int32)
    t_base = np.zeros(n, np.int64)
    sel_idx = np.full((n, max_anchors), -1, np.int64)  # flat anchor indices
    for g in range(n):
        s, e = groups.group_offsets[g], groups.group_offsets[g + 1]
        size = int(e - s)
        if size > max_anchors:
            pick = np.linspace(s, e - 1, max_anchors).astype(np.int64)
        else:
            pick = np.arange(s, e)
        m = len(pick)
        base = int(groups.t_end[pick[0]])
        q[g, :m] = groups.q_end[pick]
        t[g, :m] = (groups.t_end[pick] - base).astype(np.int32)
        cnt[g] = m
        t_base[g] = base
        sel_idx[g, :m] = pick
    if n and q.max() < 2 ** 15 and t.max() < 2 ** 15 and q.min() >= 0:
        q = q.astype(np.int16)
        t = t.astype(np.int16)
    return q, t, cnt, t_base, sel_idx

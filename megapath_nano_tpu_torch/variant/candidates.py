"""Variant candidate extraction and input-tensor construction.

The Clair-ensemble preprocessing equivalents (reference:
bin/Clair-ensemble/Clair.beta.ensemble.cpu/preprocess/
ExtractVariantCandidates.py and CreateTensor.py): candidates are pileup
positions whose non-reference allele frequency passes the threshold
(AF >= 0.125 in the amplicon pipeline, runClair-ensemble.sh:44-47); each
candidate becomes a (2*flanking+1) x 8 x 4 summary tensor
(flankingBaseNum=16 → 33 positions; matrixRow=8; matrixNum=4 — shared/
param.py). Channel/row semantics here are redefined for this framework's
pileup (documented below) rather than byte-copied from Clair.

Tensor layout (positions x 8 rows x 4 channels):
  rows 0-3: base counts A/C/G/T from reads, normalized by depth cap
  row 4:    deletion count
  row 5:    reference one-hot
  row 6:    depth (broadcast)
  row 7:    non-ref fraction
  channels: [all reads, forward strand, reverse strand, near-candidate mask]

The port's own copy of megapath_nano_tpu/variant/candidates.py, with
`stranded_pileup` vectorised over CIGAR run arrays (the same counts).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from itertools import chain
from operator import itemgetter

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.utils.dna import revcomp
from megapath_nano_tpu_torch.utils.log import count, span

FLANKING = 16
POSITIONS = 2 * FLANKING + 1   # 33
ROWS = 8
CHANNELS = 4
MATRIX_DEPTH_CAP = 100         # shared/param.py matrix_depth


@dataclass
class Candidate:
    sequence_id: int
    position: int               # 0-based
    ref_base: int
    depth: int
    alt_fraction: float
    # strand-resolved pileup around the position, (POSITIONS, 6, 2):
    # rows A/C/G/T/del/depth x [fwd, rev]
    context: np.ndarray


def alignments_on(align_list: AlignList, sequence_id: int):
    """(rows, CIGAR entries) of the alignments on a sequence whose read has
    a CIGAR under (read_id, sequence_id), in row order."""
    rows = align_list.data[align_list.data["sequence_id"] == sequence_id]
    got = [align_list.cigar_map.get((int(rid), sequence_id))
           for rid in rows["read_id"]]
    keep = np.array([e is not None for e in got], bool)
    return rows[keep], [e for e in got if e is not None]


def cigar_runs(cigars: list, q_starts: np.ndarray, t_starts: np.ndarray
               ) -> tuple[np.ndarray, ...]:
    """CIGARs (lists of (length, op)) as run arrays, walked as the
    reference's loops walk them: M moves the read and the reference, I the
    read, D the reference, any other op neither. Returns (aln, q, t, length,
    op): per run its alignment's index, the oriented-read and reference
    positions where it starts (from the alignment's q_starts / t_starts),
    its length and its op letter's byte."""
    n_ops = np.fromiter(map(len, cigars), np.int64, len(cigars))
    flat = list(chain.from_iterable(cigars))
    if not flat:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty, empty, np.zeros(0, np.uint8)
    length = np.fromiter(map(itemgetter(0), flat), np.int64, len(flat))
    op = np.frombuffer("".join(map(itemgetter(1), flat)).encode(), np.uint8)
    aln = np.repeat(np.arange(len(cigars)), n_ops)
    is_m = op == ord("M")
    dq = np.where(is_m | (op == ord("I")), length, 0)
    dt = np.where(is_m | (op == ord("D")), length, 0)
    first = np.cumsum(n_ops) - n_ops
    cq = np.concatenate([[0], np.cumsum(dq)])
    ct = np.concatenate([[0], np.cumsum(dt)])
    q = np.asarray(q_starts, np.int64)[aln] + cq[:-1] - cq[first][aln]
    t = np.asarray(t_starts, np.int64)[aln] + ct[:-1] - ct[first][aln]
    return aln, q, t, length, op


def offsets_at(runs, alns: np.ndarray, pos: int) -> np.ndarray:
    """Per alignment of `alns`, its oriented-read offset at reference
    position pos from `cigar_runs`' arrays: q + (pos - t) inside an M run,
    -(q + 1) inside a D run (deleted at this read), and NOT_COVERED where
    no M or D run of the alignment holds pos (the loops' None)."""
    aln, q, t, length, op = runs
    out = np.full(len(alns), NOT_COVERED, np.int64)
    md = ((op == ord("M")) | (op == ord("D"))) & (length > 0)
    if not md.any() or len(alns) == 0:
        return out
    aln, q, t, length, op = aln[md], q[md], t[md], length[md], op[md]
    # M and D runs tile each alignment's reference span in order, so the
    # run holding pos is the alignment's last run starting at or before it
    lo = min(int(t.min()), pos)
    stride = max(int((t + length).max()), pos + 1) - lo + 1
    keys = aln * stride + (t - lo)
    i = np.searchsorted(keys, np.asarray(alns, np.int64) * stride
                        + (pos - lo), side="right") - 1
    ic = np.maximum(i, 0)
    hit = (i >= 0) & (aln[ic] == alns) & (t[ic] <= pos) \
        & (pos < t[ic] + length[ic])
    deleted = op[ic] == ord("D")
    val = np.where(deleted, -(q[ic] + 1), q[ic] + (pos - t[ic]))
    out[hit] = val[hit]
    return out


# offsets_at's mark of an alignment that does not cover the position
NOT_COVERED = np.iinfo(np.int64).min
# bases of M runs expanded at a time by the pileup (it bounds the expanded
# arrays), and the threads that count the chunks: on an amplicon's deep
# pileup they overlap numpy's gathers and counts (PERF.md, section 6)
_PILEUP_CHUNK = 1 << 22
_PILEUP_THREADS = 4


def _interval_counts(first, length, n):
    """(n,) how many of the intervals [first, first + length) hold each
    of 0 .. n - 1."""
    live = length > 0
    edge = np.bincount(first[live], minlength=n + 1) \
        - np.bincount(first[live] + length[live], minlength=n + 1)
    return np.cumsum(edge[:n])


def _base_counts(flat, base_at, slot_at, length, n):
    """(4, n) A/C/G/T counts of M runs: run i reads flat[base_at[i]:] and
    counts into slots slot_at[i]: onwards, length[i] bases (N left out)."""
    ln = length.astype(np.int32)
    first = np.cumsum(length) - length
    k = np.arange(int(length.sum()), dtype=np.int32)
    b = flat[np.repeat((base_at - first).astype(np.int32), ln) + k]
    key = np.repeat((slot_at - first).astype(np.int32), ln) + k
    key += np.minimum(b, 4).astype(np.int32) * np.int32(n)
    return np.bincount(key, minlength=5 * n)[:4 * n].reshape(4, n)


def stranded_pileup(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    seq_len: int,
) -> np.ndarray:
    """(6, seq_len, 2) strand-resolved counts: A/C/G/T/del/total.

    Every alignment on the sequence whose read has a CIGAR under
    (read_id, sequence_id) is counted from its row's sequence_from: an M
    base adds to its base's row (A/C/G/T only) and to the depth, a deleted
    reference base to the deletion row and the depth, at positions inside
    [0, seq_len). The CIGARs become run arrays once, clipped to the
    sequence; the covered positions are numbered (a run's are consecutive);
    the deletion and depth rows are interval counts over those numbers, and
    the base rows one np.bincount per chunk of M runs of one strand,
    expanded with np.repeat over the oriented reads laid end to end."""
    counts = np.zeros((6, seq_len, 2), np.int32)
    assert align_list.cigar_map is not None
    with span("variant.pileup"):
        rows, entries = alignments_on(align_list, sequence_id)
        count("pileup_alignments", len(entries))
        if not entries:
            count("pileup_bases", 0)
            return counts
        strand = np.array([int(e[2]) for e in entries], np.int64)
        aln, q, t, length, op = cigar_runs(
            [e[0] for e in entries], [e[1] for e in entries],
            rows["sequence_from"])
        md = (op == ord("M")) | (op == ord("D"))
        aln, q, t, length, is_m = aln[md], q[md], t[md], length[md], \
            op[md] == ord("M")
        # clip every run to [0, seq_len): the read moves with its start
        a = np.clip(t, 0, seq_len)
        length = np.maximum(np.clip(t + length, 0, seq_len) - a, 0)
        q, t = q + (a - t), a
        covered = _interval_counts(t, length, seq_len) > 0
        cols = np.flatnonzero(covered)
        n = len(cols)
        slot_t = (np.cumsum(covered) - 1)[np.minimum(t, seq_len - 1)]
        binned = np.zeros((6, n, 2), np.int64)
        s_run = strand[aln]
        oriented = [revcomp(reads[rid]) if st else reads[rid]
                    for rid, st in zip(rows["read_id"].tolist(),
                                       strand.tolist())]
        read_len = np.array([len(o) for o in oriented], np.int64)
        base_at = q + (np.cumsum(read_len) - read_len)[aln]
        flat = np.concatenate(oriented)
        chunks = []
        for s in (0, 1):
            mine = s_run == s
            binned[5, :, s] = _interval_counts(slot_t[mine], length[mine], n)
            dels = mine & ~is_m
            binned[4, :, s] = _interval_counts(slot_t[dels], length[dels], n)
            sel = np.flatnonzero(mine & is_m & (length > 0))
            ends = np.cumsum(length[sel])
            start = 0
            while start < len(sel):
                done = ends[start - 1] if start else 0
                stop = max(int(np.searchsorted(ends, done + _PILEUP_CHUNK,
                                               side="right")), start + 1)
                chunks.append((s, sel[start:stop]))
                start = stop

        def bases(chunk):
            s, part = chunk
            return s, _base_counts(flat, base_at[part], slot_t[part],
                                   length[part], n)

        with ThreadPoolExecutor(min(_PILEUP_THREADS, len(chunks)) or 1) \
                as pool:
            for s, c in pool.map(bases, chunks):
                binned[:4, :, s] += c
        counts[:, cols, :] += binned.astype(np.int32)
        count("pileup_bases", int(binned[:5].sum()))
    return counts


def extract_candidates(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    ref_seq: np.ndarray,
    *,
    min_af: float = 0.125,
    min_depth: int = 4,
    min_alt_count: int = 2,
) -> list[Candidate]:
    seq_len = len(ref_seq)
    counts = stranded_pileup(align_list, reads, sequence_id, seq_len)
    total = counts[5].sum(axis=1)                   # (L,)
    base_tot = counts[:4].sum(axis=2)               # (4, L)
    del_tot = counts[4].sum(axis=1)
    ref_idx = np.clip(ref_seq, 0, 3)
    ref_support = base_tot[ref_idx, np.arange(seq_len)]
    alt_support = base_tot.sum(axis=0) + del_tot - ref_support
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(total > 0, alt_support / np.maximum(total, 1), 0.0)
    cand_pos = np.flatnonzero((total >= min_depth)
                              & (alt_support >= min_alt_count)
                              & (af >= min_af)
                              & (ref_seq < 4))
    out = []
    for p in cand_pos:
        lo = p - FLANKING
        hi = p + FLANKING + 1
        ctx = np.zeros((POSITIONS, 6, 2), np.int32)
        src_lo, src_hi = max(lo, 0), min(hi, seq_len)
        ctx[src_lo - lo: src_hi - lo] = np.transpose(
            counts[:, src_lo:src_hi], (1, 0, 2))
        out.append(Candidate(
            sequence_id=sequence_id, position=int(p),
            ref_base=int(ref_seq[p]), depth=int(total[p]),
            alt_fraction=float(af[p]), context=ctx))
    return out


def candidate_tensor(cand: Candidate, ref_seq: np.ndarray) -> np.ndarray:
    """(POSITIONS, ROWS, CHANNELS) float32 input tensor."""
    t = np.zeros((POSITIONS, ROWS, CHANNELS), np.float32)
    ctx = cand.context.astype(np.float32)           # (33, 6, 2)
    depth = np.maximum(ctx[:, 5, :].sum(axis=1), 1.0)
    cap = float(MATRIX_DEPTH_CAP)
    both = ctx.sum(axis=2)                          # (33, 6)
    for ch, sel in enumerate((both, ctx[:, :, 0], ctx[:, :, 1])):
        t[:, 0:4, ch] = np.minimum(sel[:, 0:4], cap) / cap
        t[:, 4, ch] = np.minimum(sel[:, 4], cap) / cap
        t[:, 6, ch] = np.minimum(sel[:, 5] if sel.shape[1] > 5
                                 else depth, cap) / cap
    # row 5: normalized reference base; row 7: non-ref fraction
    lo = cand.position - FLANKING
    for i in range(POSITIONS):
        rp = lo + i
        if 0 <= rp < len(ref_seq) and ref_seq[rp] < 4:
            t[i, 5, :] = float(ref_seq[rp] + 1) / 4.0
    ref_sup = np.array([
        both[i, np.clip(ref_seq[lo + i], 0, 3)]
        if 0 <= lo + i < len(ref_seq) else 0.0
        for i in range(POSITIONS)])
    tot = np.maximum(both[:, 5], 1.0)
    t[:, 7, 0] = 1.0 - np.minimum(ref_sup / tot, 1.0)
    # channel 3: center-position mask
    t[FLANKING, :, 3] = 1.0
    return t

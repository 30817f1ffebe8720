"""Local realignment around candidate variants.

Reimplements the ONT local-realignment pass (reference:
bin/realignment/local_realignment.py:24-25 ±200 bp windows, :321-327
FastPassAligner SSW of each read's local sequence against ±300 bp of
reference with match 4 / mismatch 6 / gapO 8 / gapE 2
(fast_align_reads2ref.py:4-8), then recounting alt support from the new
CIGARs (:362-406) — the same libssw-parity core (cpp/mpn_ssw.cc) does the
alignment here, via the threaded banded batch API.

The port's own copy of megapath_nano_tpu/variant/realign.py, with the
covering reads and their offsets found from CIGAR run arrays (the same
counts).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.native.banded import banded_align_batch
from megapath_nano_tpu_torch.utils.dna import revcomp
from megapath_nano_tpu_torch.utils.log import count, span
from megapath_nano_tpu_torch.variant.candidates import (NOT_COVERED,
                                                        alignments_on,
                                                        cigar_runs,
                                                        offsets_at)

READ_WINDOW = 200     # bases of read on each side of the candidate
REF_WINDOW = 300      # bases of reference on each side


@dataclass
class RealignedCounts:
    position: int
    depth: int
    base_counts: np.ndarray      # (5,) A/C/G/T/del support after realignment
    ref_support: int
    alt_support: int


def realign_candidates(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    ref_seq: np.ndarray,
    positions: list[int],
    *,
    match: int = 4,
    mismatch: int = 6,
    gap_open: int = 8,
    gap_extend: int = 2,
) -> list[RealignedCounts]:
    """For each candidate position, realign overlapping reads' local windows
    and recount base support at the position.

    A read overlaps when its row's [sequence_from, sequence_to) holds the
    position and its CIGAR (the (read_id, sequence_id) entry) has an M or D
    run there; its offset at the position, on the original CIGAR and on
    the realigned one, comes from `cigar_runs` arrays by `offsets_at`."""
    assert align_list.cigar_map is not None
    with span("variant.realign"):
        out, n_pairs = _realign(align_list, reads, sequence_id, ref_seq,
                                positions, dict(match=match, mismatch=mismatch,
                                                gap_open=gap_open,
                                                gap_extend=gap_extend))
        count("realign_calls", len(positions))
        count("realign_pairs", n_pairs)
    return out


def _realign(align_list, reads, sequence_id, ref_seq, positions, scores):
    """realign_candidates' body: (the counts, the pairs realigned)."""
    rows, entries = alignments_on(align_list, sequence_id)
    runs = cigar_runs([e[0] for e in entries], [e[1] for e in entries],
                      rows["sequence_from"])
    seq_from = rows["sequence_from"].astype(np.int64)
    seq_to = rows["sequence_to"].astype(np.int64)
    oriented: dict[int, np.ndarray] = {}

    def oriented_read(i):
        if i not in oriented:
            read = reads[int(rows["read_id"][i])]
            oriented[i] = revcomp(read) if entries[i][2] else read
        return oriented[i]

    out = []
    n_pairs = 0
    for pos in positions:
        ref_lo = max(pos - REF_WINDOW, 0)
        ref_hi = min(pos + REF_WINDOW + 1, len(ref_seq))
        ref_win = ref_seq[ref_lo:ref_hi]
        cover = np.flatnonzero((seq_from <= pos) & (pos < seq_to))
        offs = offsets_at(runs, cover, pos)
        local_reads = []
        for i, off in zip(cover[offs != NOT_COVERED].tolist(),
                          offs[offs != NOT_COVERED].tolist()):
            o = oriented_read(i)
            center = abs(off) - (1 if off < 0 else 0)
            lo = max(center - READ_WINDOW, 0)
            hi = min(center + READ_WINDOW + 1, len(o))
            local_reads.append(o[lo:hi])
        if not local_reads:
            out.append(RealignedCounts(pos, 0, np.zeros(5, np.int64), 0, 0))
            continue
        n_pairs += len(local_reads)
        alns = banded_align_batch(local_reads, [ref_win] * len(local_reads),
                                  band=256, **scores)
        live = [j for j, a in enumerate(alns) if a.score > 0]
        counts = np.zeros(5, np.int64)
        if live:
            offs = offsets_at(
                cigar_runs([alns[j].cigar for j in live],
                           [alns[j].read_begin for j in live],
                           [alns[j].ref_begin for j in live]),
                np.arange(len(live)), pos - ref_lo)
            hit = offs != NOT_COVERED
            counts[4] = int(np.count_nonzero(hit & (offs < 0)))
            bases = np.array([local_reads[live[j]][off] for j, off in
                              enumerate(offs.tolist())
                              if off != NOT_COVERED and off >= 0],
                             np.int64)
            counts[:4] = np.bincount(bases[bases < 4], minlength=4)[:4]
        depth = int(counts.sum())
        ref_base = int(ref_seq[pos]) if ref_seq[pos] < 4 else -1
        ref_sup = int(counts[ref_base]) if 0 <= ref_base < 4 else 0
        out.append(RealignedCounts(pos, depth, counts, ref_sup,
                                   depth - ref_sup))
    return out, n_pairs

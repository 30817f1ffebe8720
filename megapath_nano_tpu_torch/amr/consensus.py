"""Consensus sequence construction from aligned reads.

Replaces the reference's shell consensus chain (reference:
bin/megapath_nano_amr.py:36-46: `bedtools bamtobed | bedops -m` covered
regions, `bcftools mpileup | call -mv | consensus -m 0cov.bed`, `seqtk cutN`)
with a direct CIGAR pileup: project every best alignment's bases onto its
target via the stored CIGAR, take the majority base per covered position
(ties → reference base), mask zero-coverage positions, and split masked
regions into contigs — one pass, no subprocesses.

The port's own copy of megapath_nano_tpu/amr/consensus.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.utils.dna import revcomp


@dataclass
class ConsensusContig:
    sequence_id: int
    start: int              # position on the target
    seq: np.ndarray         # numeric codes


def pileup_counts(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    seq_len: int,
) -> np.ndarray:
    """(5, L) counts of A/C/G/T/del per target position from CIGAR walks."""
    counts = np.zeros((5, seq_len), np.int32)
    assert align_list.cigar_map is not None, "align_list must carry CIGARs"
    rows = align_list.data[align_list.data["sequence_id"] == sequence_id]
    for row in rows:
        key = (int(row["read_id"]), int(row["sequence_id"]))
        entry = align_list.cigar_map.get(key)
        if entry is None:
            continue
        cigar, oriented_from, strand = entry
        read = reads[int(row["read_id"])]
        oriented = revcomp(read) if strand else read
        qi = oriented_from
        ti = int(row["sequence_from"])
        for length, op in cigar:
            if op == "M":
                seg = oriented[qi: qi + length]
                pos = np.arange(ti, ti + length)
                ok = (pos >= 0) & (pos < seq_len) & (seg < 4)
                np.add.at(counts, (seg[ok], pos[ok]), 1)
                qi += length
                ti += length
            elif op == "I":
                qi += length
            elif op == "D":
                pos = np.arange(ti, ti + length)
                ok = (pos >= 0) & (pos < seq_len)
                np.add.at(counts[4], pos[ok], 1)
                ti += length
    return counts


def consensus_contigs(
    align_list: AlignList,
    reads: list[np.ndarray],
    sequence_id: int,
    ref_seq: np.ndarray,
    *,
    min_depth: int = 1,
) -> list[ConsensusContig]:
    """Majority-base consensus, split at uncovered positions.

    Positions with depth < min_depth are masked (the reference's 0-coverage
    bed + seqtk cutN); deletions winning the majority drop the base."""
    seq_len = len(ref_seq)
    counts = pileup_counts(align_list, reads, sequence_id, seq_len)
    depth = counts.sum(axis=0)
    covered = depth >= min_depth
    # majority base; ties resolved toward the reference base
    best = np.argmax(counts[:4], axis=0)
    best_n = counts[np.minimum(best, 3), np.arange(seq_len)]
    ref_n = counts[np.clip(ref_seq, 0, 3), np.arange(seq_len)]
    call = np.where(ref_n >= best_n, np.clip(ref_seq, 0, 4), best)
    is_del = counts[4] > np.maximum(best_n, ref_n)

    contigs: list[ConsensusContig] = []
    run_start = None
    buf: list[int] = []
    for i in range(seq_len):
        if covered[i]:
            if run_start is None:
                run_start = i
                buf = []
            if not is_del[i]:
                buf.append(int(call[i]))
        else:
            if run_start is not None and buf:
                contigs.append(ConsensusContig(
                    sequence_id, run_start, np.array(buf, np.int8)))
            run_start = None
    if run_start is not None and buf:
        contigs.append(ConsensusContig(sequence_id, run_start,
                                       np.array(buf, np.int8)))
    return contigs

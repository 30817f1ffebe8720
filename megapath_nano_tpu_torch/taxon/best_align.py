"""Abundance-weighted best-alignment-per-read selection.

Exact reimplementation of align_list_to_best_align_list (reference:
bin/megapath_nano.py:244-310):

1. Reduce to best alignment per (read, assembly).
2. Keep only alignments equal to each read's max score.
3. Reads with a UNIQUE max → assigned directly; their per-assembly stats
   define assembly_abundance = adjusted_total_aligned_bp.
4. Reads with TIES → tiebreaker = U(0,1) * relative_abundance of the
   candidate assembly (relative to the sum over the read's candidates);
   highest (score, tiebreaker) wins.

The reference re-randomizes the tiebreaker with random.random() seeded from
query filenames (lib/aligner.py:160-168, megapath_nano.py:303); here the
uniform comes from a deterministic per-row hash so runs are reproducible
bit-for-bit.

The port's own copy of megapath_nano_tpu/taxon/best_align.py.
"""

from __future__ import annotations

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.taxon.abundance import (
    AssemblyInfo, align_stat_by_assembly, best_per_read_assembly)


def _hash_uniform(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + b.astype(np.uint64) + np.uint64(seed) * np.uint64(0x632BE59BD9B4E019))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def best_align_list(
    align_list: AlignList,
    info: AssemblyInfo,
    noise_bed: np.ndarray | None = None,
    *,
    seed: int = 1,
) -> AlignList:
    """One best alignment per read, abundance-weighted on ties."""
    if len(align_list) == 0:
        return align_list
    data = best_per_read_assembly(align_list.data)

    # per-read max score and tie count
    rids, seg = np.unique(data["read_id"], return_inverse=True)
    n_reads = len(rids)
    max_score = np.full(n_reads, -1, np.int64)
    np.maximum.at(max_score, seg, data["alignment_score"])
    at_max = data["alignment_score"] == max_score[seg]
    data = data[at_max]
    seg = seg[at_max]
    tie_count = np.zeros(n_reads, np.int64)
    np.add.at(tie_count, seg, 1)

    unique_mask = tie_count[seg] == 1
    unique_part = data[unique_mask]
    tied_part = data[~unique_mask]
    tied_seg = seg[~unique_mask]

    if len(tied_part) == 0:
        combined = unique_part
    else:
        # abundance from the uniquely-assigned reads only (ref :275-283)
        stat = align_stat_by_assembly(
            AlignList(unique_part, align_list.sequence_names,
                      align_list.assembly_names, align_list.read_names),
            info, noise_bed)
        abundance = {int(r["assembly_id"]): float(r["adjusted_total_aligned_bp"])
                     for r in stat}
        asm_ab = np.array([abundance.get(int(a), 0.0)
                           for a in tied_part["assembly_id"]])
        read_ab = np.zeros(n_reads, np.float64)
        np.add.at(read_ab, tied_seg, asm_ab)
        rel_ab = np.where(read_ab[tied_seg] <= 0, 1.0,
                          asm_ab / np.maximum(read_ab[tied_seg], 1e-300))
        u = _hash_uniform(tied_part["read_id"],
                          tied_part["assembly_id"].astype(np.int64), seed)
        tied_part = tied_part.copy()
        tied_part["alignment_score_tiebreaker"] = u * rel_ab
        combined = np.concatenate([unique_part, tied_part])

    order = np.lexsort((combined["alignment_score_tiebreaker"],
                        combined["alignment_score"], combined["read_id"]))
    d = combined[order]
    last = np.append(d["read_id"][1:] != d["read_id"][:-1], True)
    return AlignList(d[last], align_list.sequence_names,
                     align_list.assembly_names, align_list.read_names,
                     align_list.cigar_map)

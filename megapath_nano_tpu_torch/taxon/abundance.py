"""Abundance statistics — the metric core of the taxon module.

Exact reimplementation of the reference's summary_stat_1/summary_stat_2 and
align_list_to_align_stat_by_assembly_id (reference: bin/megapath_nano.py:
495-518, 521-620):

  average_depth            = total_aligned_bp / length
  covered_percent          = covered_bp / length
  adjusted_covered_percent = covered_bp / (length - noise_span_bp)
  adjusted_average_depth   = adjusted_covered_percent * total_aligned_bp
                             / (length - noise_span_bp)
  adjusted_total_aligned_bp = round(adjusted_average_depth * length)
  average_identity         = match / total_aligned_bp

All reductions are per-assembly segment sums over the per-(read, assembly)
best alignments, in numpy.

The port's own copy of megapath_nano_tpu/taxon/abundance.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.taxon.intervals import (
    covered_bp_by_assembly, make_bed, merge_bed, subtract_bed)

STAT_DTYPE = np.dtype([
    ("assembly_id", np.int32),
    ("total_number_of_read", np.int64),
    ("total_read_bp", np.int64),
    ("total_aligned_bp", np.int64),
    ("match", np.int64),
    ("edit_dist", np.int64),
    ("alignment_score", np.int64),
    ("assembly_length", np.int64),
    ("tax_id", np.int64),
    ("species_tax_id", np.int64),
    ("genus_tax_id", np.int64),
    ("covered_bp", np.int64),
    ("noise_span_bp", np.int64),
    ("average_read_length", np.float64),
    ("average_depth", np.float64),
    ("covered_percent", np.float64),
    ("noise_span_percent", np.float64),
    ("adjusted_covered_percent", np.float64),
    ("average_identity", np.float64),
    ("average_edit_dist", np.float64),
    ("average_alignment_score", np.float64),
    ("adjusted_average_depth", np.float64),
    ("adjusted_total_aligned_bp", np.int64),
])


def best_per_read_assembly(data: np.ndarray) -> np.ndarray:
    """Best alignment per (read, assembly): max (alignment_score, tiebreaker)
    — the reference's sort_values + drop_duplicates keep='last'
    (megapath_nano.py:249, :538)."""
    if len(data) == 0:
        return data
    order = np.lexsort((data["alignment_score_tiebreaker"],
                        data["alignment_score"],
                        data["assembly_id"], data["read_id"]))
    d = data[order]
    last_of_group = np.append(
        (d["read_id"][1:] != d["read_id"][:-1])
        | (d["assembly_id"][1:] != d["assembly_id"][:-1]), True)
    return d[last_of_group]


def _segment_sum(values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, values.dtype)
    np.add.at(out, seg, values)
    return out


@dataclass
class AssemblyInfo:
    """Assembly length + taxonomy lookup tables indexed by assembly_id."""

    length: np.ndarray           # (n_assemblies,) int64
    tax_id: np.ndarray
    species_tax_id: np.ndarray
    genus_tax_id: np.ndarray

    @staticmethod
    def from_lengths(lengths) -> "AssemblyInfo":
        n = len(lengths)
        return AssemblyInfo(np.asarray(lengths, np.int64),
                            np.zeros(n, np.int64), np.zeros(n, np.int64),
                            np.zeros(n, np.int64))


def align_stat_by_assembly(
    align_list: AlignList,
    info: AssemblyInfo,
    noise_bed: np.ndarray | None = None,
) -> np.ndarray:
    """Per-assembly stats over per-(read, assembly) best alignments.

    noise_bed (merged) removes covered regions and contributes noise_span_bp,
    matching align_list_to_align_stat_by_assembly_id with noise_bed
    (megapath_nano.py:521-620)."""
    data = best_per_read_assembly(align_list.data)
    aids = np.unique(data["assembly_id"]) if len(data) else np.zeros(0, np.int32)
    n = len(aids)
    out = np.zeros(n, STAT_DTYPE)
    out["assembly_id"] = aids
    if n == 0:
        return out
    remap = {int(a): i for i, a in enumerate(aids)}
    seg = np.array([remap[int(a)] for a in data["assembly_id"]], np.int64)

    out["total_number_of_read"] = _segment_sum(
        np.ones(len(data), np.int64), seg, n)
    out["total_read_bp"] = _segment_sum(data["read_length"], seg, n)
    aligned = data["sequence_to"] - data["sequence_from"]
    out["total_aligned_bp"] = _segment_sum(aligned, seg, n)
    out["match"] = _segment_sum(data["match"], seg, n)
    out["edit_dist"] = _segment_sum(data["edit_dist"], seg, n)
    out["alignment_score"] = _segment_sum(data["alignment_score"], seg, n)

    out["assembly_length"] = info.length[aids]
    out["tax_id"] = info.tax_id[aids]
    out["species_tax_id"] = info.species_tax_id[aids]
    out["genus_tax_id"] = info.genus_tax_id[aids]

    covered = make_bed(data["assembly_id"], data["sequence_id"],
                       data["sequence_from"], data["sequence_to"])
    covered = merge_bed(covered)
    if noise_bed is not None and len(noise_bed):
        covered = subtract_bed(covered, noise_bed)
        noise_cov = covered_bp_by_assembly(noise_bed)
    else:
        noise_cov = {}
    cov = covered_bp_by_assembly(covered)
    out["covered_bp"] = [cov.get(int(a), 0) for a in aids]
    out["noise_span_bp"] = [noise_cov.get(int(a), 0) for a in aids]

    return summary_stat_2(out)


def summary_stat_2(stat: np.ndarray) -> np.ndarray:
    """Derived columns, formula-exact to summary_stat_2 (ref :495-518).
    inf/nan from zero denominators become 0, matching the reference's
    replace(inf).fillna(0)."""
    def safe(num, den):
        with np.errstate(divide="ignore", invalid="ignore"):
            x = num / den
        return np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)

    length = stat["assembly_length"].astype(np.float64)
    adj_len = length - stat["noise_span_bp"]
    stat["average_read_length"] = safe(stat["total_read_bp"],
                                       stat["total_number_of_read"])
    stat["average_depth"] = safe(stat["total_aligned_bp"], length)
    stat["covered_percent"] = safe(stat["covered_bp"], length)
    stat["noise_span_percent"] = safe(stat["noise_span_bp"], length)
    stat["adjusted_covered_percent"] = safe(stat["covered_bp"], adj_len)
    stat["average_identity"] = safe(stat["match"], stat["total_aligned_bp"])
    stat["average_edit_dist"] = safe(stat["edit_dist"],
                                     stat["total_aligned_bp"])
    stat["average_alignment_score"] = safe(stat["alignment_score"],
                                           stat["total_aligned_bp"])
    stat["adjusted_average_depth"] = np.nan_to_num(
        stat["adjusted_covered_percent"]
        * safe(stat["total_aligned_bp"], adj_len), nan=0.0, posinf=0.0)
    stat["adjusted_total_aligned_bp"] = np.round(
        stat["adjusted_average_depth"] * length).astype(np.int64)
    return stat


def align_stat_by_sequence(
    align_list: AlignList,
    seq_lengths: np.ndarray,
) -> np.ndarray:
    """Per-SEQUENCE stats over per-(read, sequence) best alignments —
    align_list_to_align_stat_by_sequence_id (reference megapath_nano.py:
    589-620; the .microbe_stat_by_sequence_id / .human_stat / .decoy_stat
    outputs). Reuses STAT_DTYPE with assembly_id holding the sequence id
    and assembly_length the sequence length."""
    data = align_list.data
    if len(data):
        order = np.lexsort((data["alignment_score_tiebreaker"],
                            data["alignment_score"],
                            data["sequence_id"], data["read_id"]))
        d = data[order]
        last = np.append(
            (d["read_id"][1:] != d["read_id"][:-1])
            | (d["sequence_id"][1:] != d["sequence_id"][:-1]), True)
        data = d[last]
    sids = np.unique(data["sequence_id"]) if len(data) else \
        np.zeros(0, np.int64)
    n = len(sids)
    out = np.zeros(n, STAT_DTYPE)
    out["assembly_id"] = sids
    if n == 0:
        return out
    remap = {int(s): i for i, s in enumerate(sids)}
    seg = np.array([remap[int(s)] for s in data["sequence_id"]], np.int64)
    out["total_number_of_read"] = _segment_sum(
        np.ones(len(data), np.int64), seg, n)
    out["total_read_bp"] = _segment_sum(data["read_length"], seg, n)
    aligned = data["sequence_to"] - data["sequence_from"]
    out["total_aligned_bp"] = _segment_sum(aligned, seg, n)
    out["match"] = _segment_sum(data["match"], seg, n)
    out["edit_dist"] = _segment_sum(data["edit_dist"], seg, n)
    out["alignment_score"] = _segment_sum(data["alignment_score"], seg, n)
    out["assembly_length"] = seq_lengths[sids]
    out["tax_id"] = [data["tax_id"][seg == i][0] for i in range(n)]
    out["species_tax_id"] = [data["species_tax_id"][seg == i][0]
                             for i in range(n)]
    out["genus_tax_id"] = [data["genus_tax_id"][seg == i][0]
                           for i in range(n)]
    # covered bp per sequence: merge intervals keyed by sequence alone
    covered = make_bed(data["sequence_id"], data["sequence_id"],
                       data["sequence_from"], data["sequence_to"])
    covered = merge_bed(covered)
    cov = covered_bp_by_assembly(covered)
    out["covered_bp"] = [cov.get(int(s), 0) for s in sids]
    return summary_stat_2(out)

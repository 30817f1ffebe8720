"""Noise detection / removal / source statistics (reference steps 22-24).

Reference: bin/megapath_nano.py
  step_noise_detection_statistics (:2944)  — per-assembly noise SPAN stats
  step_noise_removal_statistics  (:3010)   — per-assembly noise ALIGNMENT
    stats, one column block per noise source (spike / human / microbe /
    closing_spike / combined / short / all)
  step_noise_source_statistics   (:3138)   — target<-source attribution:
    for each best alignment removed as noise, the target assembly it sat on
    vs the source assembly its read finally belongs to (or human / decoy /
    'unidentified' for non-microbe reads), with read/bp sums

The port's own copy of megapath_nano_tpu/taxon/noise_stats.py.
"""

from __future__ import annotations

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.taxon.intervals import make_bed, overlap_bp

NOISE_SOURCE_ORDER = ["spike", "human_repetitive", "microbe_repetitive",
                      "closing_spike", "variable_region"]


def select_alignment_rows_by_bed(align_list: AlignList,
                                 bed: np.ndarray | None,
                                 min_overlap: float = 0.5) -> np.ndarray:
    """Row mask: alignment overlaps `bed` by strictly more than
    min_overlap * alignment span (select_alignment_by_bed with
    can_equal_to_min=False, reference megapath_nano.py:666-717)."""
    n = len(align_list)
    if bed is None or len(bed) == 0 or n == 0:
        return np.zeros(n, bool)
    d = align_list.data
    q = make_bed(d["assembly_id"], d["sequence_id"],
                 d["sequence_from"], d["sequence_to"])
    ov = overlap_bp(q, bed)
    span = d["sequence_to"] - d["sequence_from"]
    return ov > min_overlap * span


def _per_assembly_sums(data: np.ndarray, mask: np.ndarray,
                       assembly_ids: np.ndarray) -> dict[int, tuple]:
    out: dict[int, list] = {int(a): [0, 0, 0] for a in assembly_ids}
    for row in data[mask]:
        a = int(row["assembly_id"])
        if a not in out:
            out[a] = [0, 0, 0]
        out[a][0] += 1
        out[a][1] += int(row["read_length"])
        out[a][2] += int(row["sequence_to"] - row["sequence_from"])
    return {a: tuple(v) for a, v in out.items()}


def noise_removal_stats(
    best_pre_noise: AlignList,
    noise_sources: dict[str, np.ndarray],
    noise_bed: np.ndarray | None,
    *,
    min_align_length: int = 0,
    overlap_fraction: float = 0.5,
):
    """Per-assembly noise-alignment stats, one (reads, read_bp, aligned_bp)
    triple per source plus 'noise' (combined bed), 'short' and 'all'.

    Returns (table, all_mask) where table maps assembly_id ->
    {source: (n_reads, read_bp, aligned_bp)} and all_mask marks the
    best_pre_noise rows counted as noise (the noise_best_align_list)."""
    d = best_pre_noise.data
    aids = np.unique(d["assembly_id"]) if len(d) else np.zeros(0, np.int64)
    masks: dict[str, np.ndarray] = {}
    for name, bed in noise_sources.items():
        masks[name] = select_alignment_rows_by_bed(
            best_pre_noise, bed, overlap_fraction)
    masks["noise"] = select_alignment_rows_by_bed(
        best_pre_noise, noise_bed, overlap_fraction)
    span = (d["sequence_to"] - d["sequence_from"]) if len(d) else \
        np.zeros(0, np.int64)
    masks["short"] = span < min_align_length
    all_mask = masks["noise"] | masks["short"]
    masks["all"] = all_mask

    table: dict[int, dict] = {int(a): {} for a in aids}
    for name, mask in masks.items():
        sums = _per_assembly_sums(d, mask, aids)
        for a, triple in sums.items():
            table.setdefault(a, {})[name] = triple
    return table, all_mask


def noise_source_stats(
    noise_best: AlignList,
    final_best: AlignList,
    *,
    human_read_ids=None,
    decoy_read_ids=None,
):
    """Target<-source attribution over the removed best alignments
    (step_noise_source_statistics, :3138-3175). Returns rows
    (target_assembly_id, source: int assembly id or 'human'/'decoy'/
    'unidentified', noise_read_count, noise_aligned_bp, noise_read_bp),
    excluding target == source."""
    src_of_read = {int(r): int(a) for r, a in
                   zip(final_best.data["read_id"],
                       final_best.data["assembly_id"])}
    human = set(int(r) for r in (human_read_ids if human_read_ids is not None
                                 else []))
    decoy = set(int(r) for r in (decoy_read_ids if decoy_read_ids is not None
                                 else []))
    agg: dict[tuple, list] = {}
    for row in noise_best.data:
        rid = int(row["read_id"])
        target = int(row["assembly_id"])
        if rid in src_of_read:
            source = src_of_read[rid]
            if source == target:
                continue
        elif rid in human:
            source = "human"
        elif rid in decoy:
            source = "decoy"
        else:
            source = "unidentified"
        key = (target, source)
        if key not in agg:
            agg[key] = [0, 0, 0]
        agg[key][0] += 1
        agg[key][1] += int(row["sequence_to"] - row["sequence_from"])
        agg[key][2] += int(row["read_length"])
    return [(t, s, c[0], c[1], c[2])
            for (t, s), c in sorted(agg.items(), key=lambda kv: (
                kv[0][0], str(kv[0][1])))]

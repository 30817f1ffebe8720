"""Per-species assembly selection — reference steps 4-6.

Reference flow (bin/megapath_nano.py):
  step 4 step_placement_to_assembly (:1313-1397): demux reads per selected
    species (nanosplit), align each group against that species' OTHER
    assemblies (the assembly-ID genome set, minimap2 -N 1000 -p 0).
  step 5 step_assembly_selection (:1400-1476): per species, pick the
    assembly with max adjusted_average_depth over the good_align_list
    (alignments >= 80% of the read's best score, :642-663); species whose
    species-set depth reaches assembly_id_min_average_depth (default 0.5,
    :5081) draw candidates from both genome sets.
  step 6 step_align_assembly_set (:1478-1538): align ALL reads against the
    chosen assemblies not already in the species set, merge with the species
    alignments restricted to the chosen assemblies; abundance-weighted best.
  gate --assembly_selection (off by default, :4987); when off, main
    (:4285-4310) picks the per-species best assembly from the species-set
    stats without re-aligning.

Shape: both genome sets are RefDBs over the same metadata
universe; per-species candidate groups are mapped with the standard
MinimizerAligner (secondary_ratio=0 mirrors -p 0), and the merged list is
expressed in a combined (main + assembly-set) id namespace.

The port's own copy of megapath_nano_tpu/taxon/assembly_selection.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import (
    AlignParams, MinimizerAligner)
from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE, AlignList
from megapath_nano_tpu_torch.taxon.abundance import (
    AssemblyInfo, align_stat_by_assembly)
from megapath_nano_tpu_torch.taxon.best_align import best_align_list


def good_align_list(align_list: AlignList,
                    ratio: float = 0.8) -> AlignList:
    """Alignments scoring >= ratio * the read's best score (:642-663)."""
    if len(align_list) == 0:
        return align_list
    d = align_list.data
    rids, inv = np.unique(d["read_id"], return_inverse=True)
    best = np.full(len(rids), -1, np.int64)
    np.maximum.at(best, inv, d["alignment_score"])
    return align_list.filter(d["alignment_score"] >= ratio * best[inv])


def select_assemblies_per_species(
    align_list: AlignList,
    info: AssemblyInfo,
    *,
    good_ratio: float = 0.8,
) -> dict[int, int]:
    """species_tax_id -> chosen assembly_id (max adjusted_average_depth over
    the good alignments; ties -> more reads, then lower id)."""
    good = good_align_list(align_list, good_ratio)
    if len(good) == 0:
        return {}
    stat = align_stat_by_assembly(good, info)
    chosen: dict[int, tuple] = {}
    for row in stat:
        sp = int(row["species_tax_id"])
        key = (float(row["adjusted_average_depth"]),
               int(row["total_number_of_read"]), -int(row["assembly_id"]))
        if sp not in chosen or key > chosen[sp][0]:
            chosen[sp] = (key, int(row["assembly_id"]))
    return {sp: asm for sp, (k, asm) in chosen.items()}


def restrict_to_selected(align_list: AlignList,
                         selected: dict[int, int]) -> AlignList:
    """Keep only alignments to each species' chosen assembly (the effect of
    the reference's species->assembly consolidation, main:4285-4310)."""
    if len(align_list) == 0 or not selected:
        return align_list
    d = align_list.data
    keep = np.array([
        selected.get(int(sp), int(asm)) == int(asm)
        for sp, asm in zip(d["species_tax_id"], d["assembly_id"])])
    return align_list.filter(keep)


def read_species_map(best: AlignList) -> dict[int, int]:
    """read_id -> species of its best alignment (read_id_species_id,
    reference megapath_nano.py:1287-1302)."""
    return {int(r): int(s) for r, s in zip(best.data["read_id"],
                                           best.data["species_tax_id"])}


@dataclass
class AssemblySelectionResult:
    align_list: AlignList            # combined-namespace downstream list
    best_align_list: AlignList       # abundance-weighted best per read
    assembly_list: dict[int, int]    # species_tax_id -> chosen assembly_id
    info: AssemblyInfo               # combined assembly info
    assembly_names: list[str]        # combined assembly name table
    sequence_names: list[str]        # combined sequence name table
    n_assembly_candidates: int = 0
    species_reached: list[int] = field(default_factory=list)


def _remap_to_combined(part: AlignList, sub_db, assembly_db,
                       seq_base: dict[str, int], asm_base: dict[str, int]):
    """Translate a subset-DB AlignList into the combined namespace by name."""
    if len(part) == 0:
        return part.data
    d = part.data.copy()
    seq_map = np.array([seq_base[n] for n in part.sequence_names], np.int64)
    asm_map = np.array([asm_base[n] for n in part.assembly_names], np.int64)
    d["sequence_id"] = seq_map[d["sequence_id"]]
    d["assembly_id"] = asm_map[d["assembly_id"]]
    return d


def run_assembly_selection(
    reads: list[np.ndarray],
    species_align_list: AlignList,
    main_db,
    assembly_db,
    *,
    selected_species: list[int] | None = None,
    min_average_depth: float = 0.5,
    good_ratio: float = 0.8,
    align_params: AlignParams | None = None,
    map_slice: int | None = None,
    device="cuda",
) -> AssemblySelectionResult:
    """Steps 4-6 against an assembly-ID genome set (assembly_db holds the
    candidate assemblies NOT in the species set; names must be disjoint
    from main_db's). Both maps run on `device`."""
    base = align_params or AlignParams()
    # -N 1000 -p 0 (reference :1381, :1508): keep all secondary loci
    import dataclasses
    p = dataclasses.replace(base, secondary_ratio=0.0,
                            max_alignments_per_read=1000)

    # combined namespace: main tables first, assembly-set appended
    n_main_asm = len(main_db.assembly_names)
    comb_asm_names = list(main_db.assembly_names) \
        + list(assembly_db.assembly_names)
    comb_seq_names = list(main_db.index.seq_names) \
        + list(assembly_db.index.seq_names)
    asm_base = {n: i for i, n in enumerate(comb_asm_names)}
    seq_base = {n: i for i, n in enumerate(comb_seq_names)}
    mi, ai = main_db.assembly_info, assembly_db.assembly_info
    comb_info = AssemblyInfo(
        length=np.concatenate([mi.length, ai.length]),
        tax_id=np.concatenate([mi.tax_id, ai.tax_id]),
        species_tax_id=np.concatenate([mi.species_tax_id,
                                       ai.species_tax_id]),
        genus_tax_id=np.concatenate([mi.genus_tax_id, ai.genus_tax_id]))

    sp_best = best_align_list(species_align_list, mi)
    rid_species = read_species_map(sp_best)
    if selected_species is None:
        selected_species = sorted({int(s) for s in
                                   sp_best.data["species_tax_id"]})
    sel_set = set(int(s) for s in selected_species)

    # step 4: per-species candidate alignment vs the assembly set
    asm_species = assembly_db.assembly_info.species_tax_id
    parts: list[np.ndarray] = []
    n_candidates = 0
    for sp in selected_species:
        cand = [assembly_db.assembly_names[a]
                for a in np.flatnonzero(asm_species == sp)]
        if not cand:
            continue
        n_candidates += len(cand)
        sp_read_ids = [r for r, s in rid_species.items() if s == sp]
        if not sp_read_ids:
            continue
        sub = assembly_db.subset(cand)
        aligner = MinimizerAligner(sub.index, sub.sequence_meta, p,
                                   device=device)
        part = aligner.map_reads([reads[r] for r in sp_read_ids],
                                 slice_size=map_slice, emit_cigars=False)
        if len(part) == 0:
            continue
        part.data["read_id"] = np.array(sp_read_ids, np.int64)[
            part.data["read_id"]]
        parts.append(_remap_to_combined(part, sub, assembly_db,
                                        seq_base, asm_base))
    assembly_align = (np.concatenate(parts) if parts
                      else np.zeros(0, ALIGN_DTYPE))

    # step 5: species-set depth gate + per-species best assembly
    sp_stat = align_stat_by_assembly(species_align_list, mi)
    best_depth: dict[int, float] = {}
    for row in sp_stat:
        sp = int(row["species_tax_id"])
        best_depth[sp] = max(best_depth.get(sp, 0.0),
                             float(row["adjusted_average_depth"]))
    species_reached = sorted(sp for sp, d in best_depth.items()
                             if d >= min_average_depth and sp in sel_set)
    reached = set(species_reached)

    keep_a = np.array([int(comb_info.species_tax_id[a]) in reached
                       for a in assembly_align["assembly_id"]], bool) \
        if len(assembly_align) else np.zeros(0, bool)
    d_sp = species_align_list.data
    keep_s = np.array([rid_species.get(int(r)) == int(s)
                       for r, s in zip(d_sp["read_id"],
                                       d_sp["species_tax_id"])], bool) \
        if len(d_sp) else np.zeros(0, bool)
    selection_data = np.concatenate([assembly_align[keep_a], d_sp[keep_s]])
    selection_list = AlignList(selection_data, comb_seq_names,
                               comb_asm_names, species_align_list.read_names)
    assembly_list = select_assemblies_per_species(selection_list, comb_info,
                                                  good_ratio=good_ratio)

    # step 6: align all reads vs newly-chosen assembly-set assemblies;
    # merge with the species alignments restricted to chosen assemblies
    new_targets = [comb_asm_names[a] for a in assembly_list.values()
                   if a >= n_main_asm]
    parts6: list[np.ndarray] = []
    if new_targets:
        sub = assembly_db.subset(new_targets)
        aligner = MinimizerAligner(sub.index, sub.sequence_meta, p,
                                   device=device)
        part = aligner.map_reads(list(reads), slice_size=map_slice,
                                 emit_cigars=False)
        if len(part):
            parts6.append(_remap_to_combined(part, sub, assembly_db,
                                             seq_base, asm_base))
    chosen = set(assembly_list.values())
    keep_main = np.array([int(a) in chosen for a in d_sp["assembly_id"]],
                         bool) if len(d_sp) else np.zeros(0, bool)
    parts6.append(d_sp[keep_main])
    out_data = np.concatenate(parts6)
    out = AlignList(out_data, comb_seq_names, comb_asm_names,
                    species_align_list.read_names)
    best = best_align_list(out, comb_info)
    return AssemblySelectionResult(
        align_list=out, best_align_list=best, assembly_list=assembly_list,
        info=comb_info, assembly_names=comb_asm_names,
        sequence_names=comb_seq_names, n_assembly_candidates=n_candidates,
        species_reached=species_reached)

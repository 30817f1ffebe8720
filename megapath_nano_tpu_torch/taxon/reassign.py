"""Global read reassignment across species (the reference's headline
"global-optimization on multiple alignments" feature).

Reimplements lib/reassignment.py (reference: bin/lib/reassignment.py:66
Reassign): per species, AllCount (reads hitting it), UCount (reads hitting
only it), MCount(i,j) (reads hitting both); species i "explains" species j
when

    AllCount_i - MCount_ij >= ratio * AllCount_i      (i not mostly shared)
    UCount_j < error_rate * UCount_i                  (j has no real support)

and alignments of explained j are relabeled to i for reads that also hit i
with AS_i >= AS_threshold * AS_j (reference defaults: ratio 0.05,
error_rate 0.05, AS_threshold 0 — reassignment.py:117-118).

Species identity here is species_tax_id (the reference derives a name string
from the first words of sequence_name — reassignment.py:69-70; our metadata
carries the tax id directly). The reference's `species_i in
i_explains_j_dict.values()` skip is a no-op (compares a string against sets)
and is intentionally not reproduced.

Counting is vectorized: pair counts come from a sorted (read, species) table
joined against itself per read — no multiprocessing pool needed.

The port's own copy of megapath_nano_tpu/taxon/reassign.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from megapath_nano_tpu_torch.align.records import AlignList


@dataclass
class ReassignResult:
    align_list: AlignList
    reassigned_mask: np.ndarray            # rows whose species was rewritten
    explains: dict[int, set]               # species i -> explained set


def reassign(
    align_list: AlignList,
    *,
    ratio: float = 0.05,
    error_rate: float = 0.05,
    as_threshold: float = 0.0,
) -> ReassignResult:
    data = align_list.data.copy()
    if len(data) == 0:
        return ReassignResult(align_list, np.zeros(0, bool), {})

    # best alignment per (read, species)  (reassignment.py:76-77)
    order = np.lexsort((data["alignment_score"], data["species_tax_id"],
                        data["read_id"]))
    d = data[order]
    last = np.append((d["read_id"][1:] != d["read_id"][:-1])
                     | (d["species_tax_id"][1:] != d["species_tax_id"][:-1]),
                     True)
    keep_idx = order[last]
    tbl = data[keep_idx]

    species, sp_inv = np.unique(tbl["species_tax_id"], return_inverse=True)
    n_sp = len(species)
    all_count = np.bincount(sp_inv, minlength=n_sp)

    # unique reads: reads appearing exactly once in tbl
    rids, r_inv, r_cnt = np.unique(tbl["read_id"], return_inverse=True,
                                   return_counts=True)
    is_unique = r_cnt[r_inv] == 1
    u_count = np.bincount(sp_inv[is_unique], minlength=n_sp)

    # MCount via per-read species pairs
    multi = r_cnt[r_inv] > 1
    mc: dict[tuple, int] = {}
    t_sorted = np.argsort(r_inv[multi], kind="stable")
    sp_multi = sp_inv[multi][t_sorted]
    rid_multi = r_inv[multi][t_sorted]
    start = 0
    while start < len(rid_multi):
        end = start
        while end < len(rid_multi) and rid_multi[end] == rid_multi[start]:
            end += 1
        row_sp = np.unique(sp_multi[start:end])
        for ai in range(len(row_sp)):
            for bi in range(ai + 1, len(row_sp)):
                key = (int(row_sp[ai]), int(row_sp[bi]))
                mc[key] = mc.get(key, 0) + 1
        start = end

    def mcount(i, j):
        return mc.get((min(i, j), max(i, j)), 0)

    # build i_explains_j over species ranked by AllCount descending
    ranking = np.argsort(-all_count, kind="stable")
    explains: dict[int, set] = {}
    explained_by: dict[int, list] = {}
    for i in ranking:
        for j in range(n_sp):
            if i == j:
                continue
            if (all_count[i] - mcount(i, j) >= ratio * all_count[i]
                    and u_count[j] < error_rate * u_count[i]):
                explains.setdefault(int(i), set()).add(int(j))
                explained_by.setdefault(int(j), []).append(int(i))

    if not explains:
        return ReassignResult(align_list, np.zeros(len(data), bool), {})

    # rank position for processing order (higher AllCount i wins)
    rank_pos = np.empty(n_sp, np.int64)
    rank_pos[ranking] = np.arange(n_sp)

    # per read: species -> best AS (from tbl)
    reassigned = np.zeros(len(data), bool)
    # for each alignment row of an explained species j, find the best-ranked
    # explaining i also hit by the same read with AS_i >= thr * AS_j
    read_species_as: dict[tuple, int] = {}
    for row in tbl:
        sp = int(np.searchsorted(species, row["species_tax_id"]))
        read_species_as[(int(row["read_id"]), sp)] = int(
            row["alignment_score"])

    sp_of_row = np.searchsorted(species, data["species_tax_id"])
    new_species = data["species_tax_id"].copy()
    # only rows of EXPLAINED species can be relabeled — restrict the loop
    # to them (typically a small minority of alignments)
    explained_mask = np.isin(sp_of_row,
                             np.array(list(explained_by), np.int64))
    for r in np.flatnonzero(explained_mask):
        j = int(sp_of_row[r])
        rid = int(data["read_id"][r])
        as_j = int(data["alignment_score"][r])
        best_i = None
        for i in sorted(explained_by[j], key=lambda s: rank_pos[s]):
            as_i = read_species_as.get((rid, i))
            if as_i is None:
                continue
            if as_j * as_threshold <= as_i:
                best_i = i
                break
        if best_i is not None:
            new_species[r] = species[best_i]
            reassigned[r] = True

    data["species_tax_id"] = new_species
    out = AlignList(data, align_list.sequence_names,
                    align_list.assembly_names, align_list.read_names,
                    align_list.cigar_map)
    return ReassignResult(
        out, reassigned,
        {int(species[i]): {int(species[j]) for j in js}
         for i, js in explains.items()})

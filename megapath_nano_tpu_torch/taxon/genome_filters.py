"""Genome-vs-genome noise filters (reference steps 8, 10, 12, 21).

The reference runs minimap2 genome-to-genome at divergence-specific presets
(reference: bin/megapath_nano.py:221-241 similarity_option maps similarity %
to minimap2 scoring hacks) for:

  step 8   variable-region detection within a species' strains (:1572-1758)
  step 10  human-repetitive regions: GRCh38 aligned to each assembly
           (:1809-1932, asm20 preset, -N 10000)
  step 12  microbe-repetitive regions between abundance-skewed pairs
           (:1968-2246, abundance-ratio ladder :2023-2055)
  step 21  similar-species marker (:2756-2943)

Realization: the source genome is tiled into overlapping chunks
that run through the standard seed-chain-extend pipeline against the target
index; "align at X% similarity" becomes an identity >= X% post-filter on the
emitted blocks (equivalent selection criterion, no scoring-matrix hacks).
Covered regions on the target become BED intervals for the noise stack.

The port's own copy of megapath_nano_tpu/taxon/genome_filters.py.
"""

from __future__ import annotations

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import (
    AlignParams, MinimizerAligner)
from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.taxon.intervals import (
    BED_DTYPE, depth_segments, make_bed, merge_bed)

# Abundance-ratio ladder (reference defaults, megapath_nano.py:5090-5095 and
# the gate structure :2033-2055): (min_ratio, similarity, same_genus_only).
# The >= 98% tiers all require the pair to share a genus (reference checks
# genus_tax_id equality for similarity_index 4, 5 AND 6).
RATIO_LADDER = [
    (160.0, 0.80, False),
    (80.0, 0.90, False),
    (40.0, 0.95, False),
    (16.0, 0.98, True),
    (8.0, 0.99, True),
    (6.4, 0.992, True),
]

# Similarity-tier seed parameters: at high divergence the default (15, 10)
# minimizers barely survive (a 15-mer is intact with prob 0.8^15 ~ 3.5% at
# 20% divergence), so low-similarity tiers seed with shorter k-mers and
# denser windows — the analogue of the reference's per-divergence
# minimap2 presets (similarity_option, megapath_nano.py:221-241). Ordered
# descending; first entry with tier_sim <= sim applies.
TIER_SEEDS = [
    (0.98, 15, 10),
    (0.95, 13, 8),
    (0.90, 11, 6),
    (0.0, 9, 4),
]


def tier_seed_params(similarity: float) -> tuple[int, int]:
    for floor, k, w in TIER_SEEDS:
        if similarity >= floor:
            return k, w
    return TIER_SEEDS[-1][1:]


# Bump whenever the computed beds change semantics (seeding tiers, chunking,
# min_block, gap_break...): on-disk pair-bed caches written by an older
# schema must be recomputed, not silently reused.
BED_CACHE_SCHEMA = 2


def chunk_genome(seq: np.ndarray, *, chunk: int = 10000,
                 overlap: int = 1000) -> list[np.ndarray]:
    """Tile a genome into overlapping pseudo-reads."""
    if len(seq) <= chunk:
        return [seq]
    out = []
    step = chunk - overlap
    for s in range(0, len(seq) - overlap, step):
        out.append(seq[s: s + chunk])
    return out


def align_genome_to_index(
    source: np.ndarray,
    target_index: MinimizerIndex,
    *,
    min_identity: float = 0.0,
    device="cuda",
    chunk: int = 4000,
    min_block: int = 100,
) -> AlignList:
    """Chunked whole-genome alignment; blocks below min_identity or shorter
    than min_block target bp dropped (short-k tier seeding can chain ~20 bp
    random matches that clear the identity filter; real homologous blocks
    are orders of magnitude longer).

    chunk 4000: each candidate group emits ONE chain, so a chunk spanning
    two homology blocks that are adjacent on the target but apart on the
    source keeps only the better block — smaller overlapping chunks bound
    that loss to a fraction of one chunk."""
    chunks = chunk_genome(source, chunk=chunk)
    # genome-vs-genome stages keep all secondary loci (minimap2 -p 0,
    # reference megapath_nano.py:1372-1387 / step_*_repetitive_region)
    # gap_break 1000: separated homology blocks 1-5 kb apart on the same
    # target must emit as INDEPENDENT alignments (local SW would otherwise
    # truncate at the junk between them and silently drop the second block)
    params = AlignParams(min_chain_score=40, max_alignments_per_read=20,
                         secondary_ratio=0.0, gap_break=1000)
    aligner = MinimizerAligner(target_index, params=params, device=device)
    res = aligner.map_reads(chunks)
    if len(res):
        d = res.data
        span = d["sequence_to"] - d["sequence_from"]
        keep = span >= min_block
        if min_identity > 0:
            ident = np.where(span > 0, d["match"] / np.maximum(span, 1), 0.0)
            keep &= ident >= min_identity
        res = res.filter(keep)
    return res


def covered_bed(align_list: AlignList,
                seq_assembly: np.ndarray) -> np.ndarray:
    """Covered target regions as a merged bed (assembly from seq mapping)."""
    if len(align_list) == 0:
        return np.zeros(0, BED_DTYPE)
    d = align_list.data
    return merge_bed(make_bed(seq_assembly[d["sequence_id"]].astype(np.int32),
                              d["sequence_id"], d["sequence_from"],
                              d["sequence_to"]))


def human_repetitive_bed(
    human_seqs: list[np.ndarray],
    target_index: MinimizerIndex,
    seq_assembly: np.ndarray,
    *,
    device="cuda",
    cache=None,
    cache_key: str | None = None,
) -> np.ndarray:
    """Step 10: regions of target assemblies that the human genome aligns to
    (asm-level similarity; reference uses asm20 ~ 80% identity floor).
    With cache + cache_key the stage result is memoized on disk — the
    reference's `.bed` cache next to each assembly (:1838-1889)."""
    def compute():
        beds = []
        for hseq in human_seqs:
            al = align_genome_to_index(hseq, target_index,
                                       min_identity=0.80, device=device)
            beds.append(covered_bed(al, seq_assembly))
        if not beds:
            return np.zeros(0, BED_DTYPE)
        return merge_bed(np.concatenate(beds))
    if cache is not None and cache_key is not None:
        return cache.get_or_compute(
            f"human_rep:{cache_key}@0.80#s{BED_CACHE_SCHEMA}", compute)
    return compute()


def microbe_repetitive_beds(
    assemblies: dict[int, list[np.ndarray]],   # assembly_id -> sequences
    abundances: dict[int, float],              # adjusted_total_aligned_bp
    genus_of: dict[int, int],
    target_index_of: dict[int, MinimizerIndex],
    seq_assembly_of: dict[int, np.ndarray],
    *,
    device="cuda",
    cache=None,
    name_of: dict[int, str] | None = None,
    targeted_max_span: float = 0.90,   # --..._targeted_max_span_percent/100
    allowed_max_span: float = 0.97,    # --..._allowed_max_span_percent/100
    ratio_ladder=None,                 # override RATIO_LADDER (the
    #                                    --..._abundance_threshold_* flags)
    depth_of: dict[int, float] | None = None,
    min_source_depth: float = 0.0,     # --..._min_average_depth: an
    #                                    assembly below this depth is never
    #                                    a noise SOURCE (:2026-2027)
) -> np.ndarray:
    """Step 12: for each (high, low) abundance pair passing the ratio
    ladder, regions of the LOW assembly covered by the HIGH genome at the
    ladder similarity become noise on the low assembly.

    Each tier seeds with divergence-matched (k, w) (tier_seed_params) and
    applies the reference's escalate/drop rule (:2153-2165): when a tier's
    bed covers > targeted_max_span of the low assembly, the pair escalates
    to the next-higher similarity tier and realigns; at the highest tier
    (99.2%) a bed still covering > allowed_max_span is DROPPED — marking
    ~all of a genome as noise means the pair is the same organism, not
    cross-talk.

    With cache + name_of each (high, low, similarity) pair bed is memoized
    on disk keyed by assembly NAMES — the reference's `.asmNN.bed` caches
    (:2087-2092): a rerun skips every pair already aligned at that
    preset."""
    ladder = ratio_ladder if ratio_ladder is not None else RATIO_LADDER
    beds = []
    ids = sorted(abundances, key=lambda a: -abundances[a])
    sims = sorted(s for _, s, _ in ladder)          # ascending similarity
    tier_idx_cache: dict[tuple, MinimizerIndex] = {}

    def tier_index(low: int, sim: float) -> MinimizerIndex:
        k, w = tier_seed_params(sim)
        base = target_index_of[low]
        if (base.k, base.w) == (k, w):
            return base
        key = (low, k, w)
        if key not in tier_idx_cache:
            seqs = assemblies[low]
            tier_idx_cache[key] = MinimizerIndex.build(
                seqs, [f"t{low}s{i}" for i in range(len(seqs))], k=k, w=w)
        return tier_idx_cache[key]

    for hi_pos, high in enumerate(ids):
        if (depth_of is not None
                and depth_of.get(high, 0.0) < min_source_depth):
            continue
        for low in ids[hi_pos + 1:]:
            ab_h, ab_l = abundances[high], abundances[low]
            if ab_l <= 0:
                continue
            ratio = ab_h / ab_l
            sim = None
            for min_ratio, similarity, same_genus in ladder:
                if ratio >= min_ratio and (
                        not same_genus
                        or genus_of.get(high) == genus_of.get(low)):
                    sim = similarity
                    break
            if sim is None:
                continue
            low_len = max(sum(len(s) for s in assemblies[low]), 1)

            def pair_bed(high=high, low=low, sim=sim):
                pbeds = []
                for hseq in assemblies[high]:
                    al = align_genome_to_index(
                        hseq, tier_index(low, sim), min_identity=sim,
                        device=device)
                    if len(al):
                        b = covered_bed(al, seq_assembly_of[low])
                        b["assembly_id"] = low
                        pbeds.append(b)
                if not pbeds:
                    return np.zeros(0, BED_DTYPE)
                return merge_bed(np.concatenate(pbeds))

            # escalate/drop ladder over ascending-similarity tiers
            bed = np.zeros(0, BED_DTYPE)
            tier = sims.index(sim)
            while True:
                sim = sims[tier]
                if cache is not None and name_of is not None:
                    key = (f"microbe_rep:{name_of[high]}->"
                           f"{name_of[low]}@{sim}#s{BED_CACHE_SCHEMA}")
                    bed = cache.get_or_compute(
                        key, lambda: pair_bed(sim=sim))
                else:
                    bed = pair_bed(sim=sim)
                covered = float((bed["end"] - bed["start"]).sum()) / low_len
                if covered > targeted_max_span:
                    if tier + 1 < len(sims):
                        tier += 1
                        continue
                    if covered > allowed_max_span:
                        bed = np.zeros(0, BED_DTYPE)   # same organism
                break
            if len(bed):
                beds.append(bed)
    if not beds:
        return np.zeros(0, BED_DTYPE)
    return merge_bed(np.concatenate(beds))


def variable_region_bed(
    strain_seqs: dict[int, list[np.ndarray]],    # assembly_id -> sequences
    target_index: MinimizerIndex,                # index of the CHOSEN assembly
    seq_assembly: np.ndarray,
    chosen_assembly: int,
    *,
    min_strain_fraction: float = 0.5,
    device="cuda",
    cache=None,
    cache_key: str | None = None,
) -> np.ndarray:
    """Step 8: region of the chosen assembly is VARIABLE if fewer than
    min_strain_fraction of the species' other strains align over it.
    With cache + cache_key the result is memoized on disk (the reference's
    `.var.bed` cache next to the assembly, :1627-1632)."""
    if cache is not None and cache_key is not None:
        hit = cache.get(f"var:{cache_key}#s{BED_CACHE_SCHEMA}")
        if hit is not None:
            return hit
    others = [a for a in strain_seqs if a != chosen_assembly]
    if not others:
        return np.zeros(0, BED_DTYPE)
    per_strain_beds = []
    for a in others:
        beds = []
        for seq in strain_seqs[a]:
            al = align_genome_to_index(seq, target_index, device=device)
            beds.append(covered_bed(al, seq_assembly))
        if beds:
            per_strain_beds.append(merge_bed(np.concatenate(beds)))
    if not per_strain_beds:
        return np.zeros(0, BED_DTYPE)
    stacked = np.concatenate(per_strain_beds)
    segs = depth_segments(stacked)
    need = min_strain_fraction * len(per_strain_beds)
    # variable = covered by fewer than `need` strains — includes totally
    # uncovered regions; compute as complement of well-covered segments
    well = segs[segs["depth"] >= need]
    from megapath_nano_tpu_torch.taxon.intervals import subtract_bed

    lens = target_index.seq_lengths
    full = make_bed(
        np.full(len(lens), chosen_assembly, np.int32),
        np.arange(len(lens), dtype=np.int32),
        np.zeros(len(lens), np.int64), np.asarray(lens, np.int64))
    well_bed = np.zeros(len(well), BED_DTYPE)
    for f in BED_DTYPE.names:
        well_bed[f] = well[f]
    out = subtract_bed(full, well_bed)
    if cache is not None and cache_key is not None:
        cache.put(f"var:{cache_key}#s{BED_CACHE_SCHEMA}", out)
    return out


def similar_species_marker(
    top_assembly_seqs: list[np.ndarray],
    sibling_index: MinimizerIndex,
    sibling_seq_assembly: np.ndarray,
    sibling_lengths: dict[int, int],
    *,
    cond1=(0.98, 0.5),
    cond2=(0.95, 0.75),
    combine: str = "or",
    device="cuda",
) -> dict[int, bool]:
    """Step 21: mark sibling assemblies similar to the genus-top assembly:
    similar if covered fraction >= 50% at 98% identity (cond 1) OR >= 75% at
    95% identity (cond 2) — combined with `combine` ("or"/"and", the
    reference's --similar_species_marker_similarity_combine_logic; defaults
    :5123-5128)."""
    per_cond: list[set[int]] = []
    for ident, min_cov in (cond1, cond2):
        hit: set[int] = set()
        beds = []
        for seq in top_assembly_seqs:
            al = align_genome_to_index(seq, sibling_index,
                                       min_identity=ident, device=device)
            beds.append(covered_bed(al, sibling_seq_assembly))
        if beds:
            merged = merge_bed(np.concatenate(beds))
            for aid, length in sibling_lengths.items():
                cov = merged[merged["assembly_id"] == aid]
                cov_bp = int((cov["end"] - cov["start"]).sum())
                if length > 0 and cov_bp / length >= min_cov:
                    hit.add(aid)
        per_cond.append(hit)
    both = (per_cond[0] | per_cond[1] if combine == "or"
            else per_cond[0] & per_cond[1])
    return {aid: True for aid in both}

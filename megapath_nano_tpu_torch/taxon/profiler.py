"""End-to-end taxonomic profiling pipeline.

The orchestrator tying the framework's stages into the reference's main flow
(reference: bin/megapath_nano.py:3890 main(); full step table in SURVEY §2.5):

  step 1  read QC                       io.read_fastq (nanofastq semantics)
  step 2  human/decoy filter            [--human_filter/--decoy_filter, off]
  step 3  placement to species          MinimizerAligner vs RefDB
  step 3b reassignment                  [--reassignment, off]
  step 9  spike filter                  [--spike_filter, off]
  step 13 noise removal                 always (drop >50%-in-noise aligns)
  step 14 short alignment removal       [--short_alignment_filter, off]
  step 15 closing spike filter          [--closing_spike_filter, off]
  step 16 combine with human/decoy      always (microbe AS must beat both)
  step 17 best alignment                always (abundance-weighted ties)
  step 18 separate human/decoy          always (read categories)
  step 19 unique alignment              [--unique_alignment, off]
  step 26 read statistics               always
  step 27 format output                 report writers

Gate-flag defaults match the reference argparse defaults
(megapath_nano.py:4982-5023).

The port's own copy of megapath_nano_tpu/taxon/profiler.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.align.pipeline import (
    AlignParams, MinimizerAligner, require_device)
from megapath_nano_tpu_torch.align.records import AlignList
from megapath_nano_tpu_torch.db.refdb import RefDB
from megapath_nano_tpu_torch.report.writers import (
    write_microbe_stat, write_preport, write_read_stat)
from megapath_nano_tpu_torch.taxon.abundance import (
    align_stat_by_assembly, align_stat_by_sequence)
from megapath_nano_tpu_torch.taxon.assembly_selection import (
    run_assembly_selection, select_assemblies_per_species)
from megapath_nano_tpu_torch.taxon.best_align import best_align_list
from megapath_nano_tpu_torch.taxon.filters import spike_filter_bed
from megapath_nano_tpu_torch.taxon.intervals import (
    make_bed, merge_bed, overlap_bp)
from megapath_nano_tpu_torch.taxon.reassign import reassign
from megapath_nano_tpu_torch.utils.log import Log


@dataclass
class ProfileOptions:
    """Gate flags; defaults match the reference's argparse defaults."""

    # QC (reference defaults: min quality 7.0, megapath_nano.py:5068)
    # (applied at read_fastq time by the CLI; profiler receives clean reads)

    # human/decoy filter (both off by default, :4985-4986)
    human_filter: bool = False
    decoy_filter: bool = False
    human_filter_score: int = 1000          # AS threshold (:5071)
    human_filter_score_percent: float = 1.0  # AS >= pct * read_len (:5073)

    reassignment: bool = False              # --reassignment (off, :5000)
    assembly_selection: bool = False        # steps 4-6 (off, :4987)
    assembly_id_min_average_depth: float = 0.5   # (:5081)
    good_align_threshold: float = 0.8       # good_alignment_threshold (:5080)
    spike_filter: bool = False              # --spike_filter (off, :4989)
    spike_stdev: float = 6.0                # mean + k*sqrt(mean) (:5100)
    human_repetitive_filter: bool = False   # step 10 (off, :4990)
    microbe_repetitive_filter: bool = False  # step 12 (off, :4991)
    # --microbe_repetitive_region_filter_abundance_threshold_{80..99_2}
    # (:5090-5095) — the ratio ladder's six min-ratio rungs
    microbe_rep_thresholds: tuple = (160.0, 80.0, 40.0, 16.0, 8.0, 6.4)
    microbe_rep_targeted_max_span: float = 0.90   # (:5096)
    microbe_rep_allowed_max_span: float = 0.97    # (:5097)
    microbe_rep_min_average_depth: float = 0.2    # (:5098)
    variable_region_adjustment: bool = False  # step 8 (off, :4988)
    variable_region_percent: float = 0.5    # --variable_region_percent/100
    #                                         (:5084, default 50)
    similar_species_marker: bool = False    # step 21 (off)
    # --similar_species_marker_* (:5123-5128): (similarity, covered-fraction)
    # condition pairs + combine logic
    similar_marker_num_genus: int = 3
    similar_marker_cond1: tuple = (0.98, 0.5)
    similar_marker_cond2: tuple = (0.95, 0.75)
    similar_marker_combine: str = "or"
    noise_projection: bool = False          # step 20 (off)
    noise_projection_reads: int = 1000
    noise_projection_num_genus: int = 3     # (:5115)
    noise_projection_read_length_multiplier: float = 0.5   # (:5118)
    # --min_percent_abundance_to_perform_noise_projection (:5116): within a
    # selected genus, every assembly with >= this % of the genus-top
    # abundance acts as a simulation SOURCE (reference :2661-2672)
    noise_projection_min_percent_abundance: float = 25.0
    # --noise_projection_simulated_read_length_bin_size (:5117): simulated
    # max read length rounds to this bin (reference :2675-2677)
    noise_projection_length_bin_size: int = 1000
    amplicon_filter_module: bool = False    # exit after placement (:1279)
    closing_spike_filter: bool = False      # off (:4992)
    closing_spike_stdev: float = 9.0        # (:5109)
    short_alignment_filter: bool = False    # off
    min_alignment_length: int = 0           # (:5106)
    unique_alignment: bool = False          # off
    unique_as_ratio: float = 0.8            # best*0.8 > 2nd (:2561-2590)
    noise_overlap_fraction: float = 0.5     # drop if >50% in noise (:5103)
    min_aligned_bp_per_species: int = 0     # species floor (:1287)
    align: AlignParams = field(default_factory=AlignParams)
    # CIGAR emission for the species placement. The taxon math itself only
    # needs PAF-level fields (the device kernel provides them exactly);
    # base-level CIGARs are required by the AMR consensus, variant
    # candidates, and the .species.sam output — callers that use those must
    # leave this True (reference: minimap2 -a, lib/aligner.py:245-261).
    emit_cigars: bool = True
    # slice size for the two-thread host/device overlap (None = one slice)
    map_slice: int | None = 2048
    reassign_ratio: float = 0.05
    reassign_error_rate: float = 0.05
    reassign_as_threshold: float = 0.0
    # on-disk cache for genome-pair alignment beds (the reference's
    # .asmNN.bed / .var.bed memoization, megapath_nano.py:1627-1632,
    # 2087-2092); None disables
    genome_pair_cache_dir: str | None = None


@dataclass
class ProfileResult:
    align_list: AlignList           # microbe alignments post noise-removal
    best: AlignList                 # best microbe alignment per read
    stat: np.ndarray                # per-assembly microbe_stat table
    noise_bed: np.ndarray | None
    n_reads_in: int
    n_reads_aligned: int
    # read categorization (step 18 separate; step 26 read_statistics)
    human_read_ids: np.ndarray = None
    decoy_read_ids: np.ndarray = None
    unique_read_ids: np.ndarray = None      # step 19 (if enabled)
    human_best: AlignList | None = None
    decoy_best: AlignList | None = None
    # noise bookkeeping (steps 22-25)
    noise_sources: dict = field(default_factory=dict)   # name -> bed
    n_noise_alignments: int = 0
    max_stat: np.ndarray | None = None      # step 25 upper-bound abundance
    similar_marks: dict = field(default_factory=dict)   # assembly -> bool
    noise_projections: list = field(default_factory=list)  # step 20 results
    # steps 4-7 products
    selected_assembly_list: dict = field(default_factory=dict)  # sp -> asm
    raw_stat: np.ndarray | None = None      # step 7 pre-noise stat table
    id_stat: np.ndarray | None = None       # identification-stage stat
    unique_stat: np.ndarray | None = None   # step 19 stat over unique reads
    pre_noise_best: AlignList | None = None  # raw best list (noise stats)
    human_stat: np.ndarray | None = None    # per-sequence human stats
    decoy_stat: np.ndarray | None = None
    # name tables covering every assembly/sequence id in this result (equal
    # to the profiler db's unless assembly selection appended candidates)
    assembly_names: list = field(default_factory=list)
    sequence_names: list = field(default_factory=list)
    sequence_lengths: np.ndarray | None = None


def _best_as_per_read(align_list: AlignList) -> dict[int, int]:
    d = align_list.data
    if len(d) == 0:
        return {}
    order = np.lexsort((d["alignment_score"], d["read_id"]))
    dd = d[order]
    last = np.append(dd["read_id"][1:] != dd["read_id"][:-1], True)
    rows = dd[last]
    return {int(r): int(s) for r, s in zip(rows["read_id"],
                                           rows["alignment_score"])}


class TaxonProfiler:
    def __init__(self, db: RefDB, options: ProfileOptions | None = None,
                 human_db: RefDB | None = None,
                 decoy_db: RefDB | None = None, log: Log | None = None,
                 aligner=None, assembly_db: RefDB | None = None, *,
                 device="cuda"):
        # every map of the profile (placement, filter DBs, assembly
        # selection, genome-vs-genome filters, noise projection) runs on
        # `device`: the GPU unless the caller passes device="cpu"
        require_device(device, "TaxonProfiler")
        self.device = device
        self.db = db
        # assembly-ID genome set: extra candidate assemblies for steps 4-6
        # (reference config/assembly_id.genome_set); names disjoint from db's
        self.assembly_db = assembly_db
        self.options = options or ProfileOptions()
        # aligner override for the placement: any object with the
        # map_reads of MinimizerAligner (an aligner over an index
        # partitioned across devices plugs in here)
        self.aligner = aligner or MinimizerAligner(
            db.index, db.sequence_meta, self.options.align, device=device)
        self.human_db = human_db
        self.decoy_db = decoy_db
        # histogram bin overrides (--read_length_bin_size /
        # --quality_score_bin_size); None = writer defaults
        self._length_bin = None
        self._quality_bin = None
        self.log = log or Log("taxon")
        self._bed_cache = None
        if self.options.genome_pair_cache_dir:
            from megapath_nano_tpu_torch.taxon.bed_cache import BedCache
            self._bed_cache = BedCache(self.options.genome_pair_cache_dir)

    def _map_filter_db(self, reads, refdb: RefDB):
        # filter passes consume scores only — never CIGARs
        aligner = MinimizerAligner(refdb.index, refdb.sequence_meta,
                                   self.options.align, device=self.device)
        return aligner.map_reads(reads, slice_size=self.options.map_slice,
                                 emit_cigars=False)

    def profile(self, reads: list[np.ndarray],
                read_names: list[str] | None = None) -> ProfileResult:
        opt = self.options
        info = self.db.assembly_info
        log = self.log

        # step 2: human/decoy filter — flag reads, keep their best AS for
        # the later combine step (megapath_nano.py:1091-1233, 2425-2441)
        human_best = decoy_best = None
        human_as: dict[int, int] = {}
        decoy_as: dict[int, int] = {}
        human_ids = np.zeros(0, np.int64)
        decoy_ids = np.zeros(0, np.int64)
        if opt.human_filter and self.human_db is not None:
            with log.step("human_filter"):
                h_aligns = self._map_filter_db(reads, self.human_db)
                human_best = best_align_list(h_aligns,
                                             self.human_db.assembly_info)
                d = human_best.data
                is_h = (d["alignment_score"] >= opt.human_filter_score) | (
                    d["alignment_score"] >= opt.human_filter_score_percent
                    * d["read_length"])
                human_ids = d["read_id"][is_h]
                human_as = _best_as_per_read(human_best.filter(is_h))
        if opt.decoy_filter and self.decoy_db is not None:
            with log.step("decoy_filter"):
                rest = [r for i, r in enumerate(reads)
                        if i not in set(human_ids.tolist())]
                rest_ids = [i for i in range(len(reads))
                            if i not in set(human_ids.tolist())]
                d_aligns = self._map_filter_db(rest, self.decoy_db)
                # remap read ids back to global
                d_aligns.data["read_id"] = np.array(rest_ids, np.int64)[
                    d_aligns.data["read_id"]]
                decoy_best = best_align_list(d_aligns,
                                             self.decoy_db.assembly_info)
                d = decoy_best.data
                is_d = (d["alignment_score"] >= opt.human_filter_score) | (
                    d["alignment_score"] >= opt.human_filter_score_percent
                    * d["read_length"])
                decoy_ids = d["read_id"][is_d]
                decoy_as = _best_as_per_read(decoy_best.filter(is_d))

        excluded = set(human_ids.tolist()) | set(decoy_ids.tolist())
        microbe_reads = [r for i, r in enumerate(reads) if i not in excluded]
        microbe_ids = [i for i in range(len(reads)) if i not in excluded]

        # step 3: placement to species
        with log.step("placement_to_species"):
            align_list = self.aligner.map_reads(
                microbe_reads, read_names,
                slice_size=self.options.map_slice,
                emit_cigars=self.options.emit_cigars)
            if len(align_list) and microbe_ids != list(range(len(reads))):
                remap = np.array(microbe_ids, np.int64)
                align_list.data["read_id"] = remap[align_list.data["read_id"]]
                if align_list.cigar_map is not None:
                    align_list.cigar_map = {
                        (int(remap[k[0]]), *k[1:]): v
                        for k, v in align_list.cigar_map.items()}
        n_aligned = len(np.unique(align_list.data["read_id"])) \
            if len(align_list) else 0

        # step 3b: reassignment
        if opt.reassignment and len(align_list):
            with log.step("reassignment"):
                align_list = reassign(
                    align_list, ratio=opt.reassign_ratio,
                    error_rate=opt.reassign_error_rate,
                    as_threshold=opt.reassign_as_threshold).align_list

        # amplicon filter mode: stop after species placement — downstream
        # tooling consumes the raw alignments (megapath_nano.py:1279-1280)
        if opt.amplicon_filter_module:
            best = best_align_list(align_list, info, None)
            stat = align_stat_by_assembly(best, info, None)
            return ProfileResult(
                align_list=align_list, best=best, stat=stat, noise_bed=None,
                n_reads_in=len(reads), n_reads_aligned=n_aligned,
                human_read_ids=human_ids, decoy_read_ids=decoy_ids,
                human_best=human_best, decoy_best=decoy_best,
                assembly_names=list(self.db.assembly_names),
                sequence_names=list(self.db.index.seq_names),
                sequence_lengths=self.db.index.seq_lengths)

        # steps 4-6: assembly selection. Gate on: demux-per-species
        # re-alignment against the assembly-ID genome set + per-species
        # best-assembly choice (megapath_nano.py:1313-1538). Gate off: the
        # per-species best assembly comes from the species-set stats without
        # re-aligning (main:4285-4310); the align_list is unchanged.
        selected_assemblies: dict[int, int] = {}
        result_seq_names = list(self.db.index.seq_names)
        result_asm_names = list(self.db.assembly_names)
        result_seq_lens = self.db.index.seq_lengths
        if len(align_list):
            if opt.assembly_selection and self.assembly_db is not None:
                with log.step("assembly_selection"):
                    sp_best = best_align_list(align_list, info, None)
                    d = sp_best.data
                    sp_bp: dict[int, int] = {}
                    for s, f, t in zip(d["species_tax_id"],
                                       d["sequence_from"],
                                       d["sequence_to"]):
                        sp_bp[int(s)] = sp_bp.get(int(s), 0) + int(t - f)
                    selected_species = sorted(
                        s for s, bp in sp_bp.items()
                        if bp >= opt.min_aligned_bp_per_species)
                    asr = run_assembly_selection(
                        reads, align_list, self.db, self.assembly_db,
                        selected_species=selected_species,
                        min_average_depth=opt.assembly_id_min_average_depth,
                        good_ratio=opt.good_align_threshold,
                        align_params=opt.align, map_slice=opt.map_slice,
                        device=self.device)
                    align_list = asr.align_list
                    info = asr.info
                    selected_assemblies = asr.assembly_list
                    result_seq_names = asr.sequence_names
                    result_asm_names = asr.assembly_names
                    result_seq_lens = np.concatenate(
                        [self.db.index.seq_lengths,
                         self.assembly_db.index.seq_lengths])
            else:
                # off branch computes the stat on the full placement list
                # (no good-alignment filter), main:4291-4310
                selected_assemblies = select_assemblies_per_species(
                    align_list, info, good_ratio=0.0)

        # step 7: raw stat — pre-noise best alignments that beat the read's
        # human/decoy score (megapath_nano.py:1546-1567). The ungated best
        # list is the identification-stage list (.id_stat,
        # id_best_align_list = assembly_selection best, main:4769).
        raw_stat_table = None
        id_stat_table = None
        raw_best = None
        if len(align_list):
            id_best = best_align_list(align_list, info, None)
            id_stat_table = align_stat_by_assembly(id_best, info, None)
            raw_best = id_best
            if human_as or decoy_as:
                d = raw_best.data
                floor = np.array(
                    [max(human_as.get(int(r), 0), decoy_as.get(int(r), 0))
                     for r in d["read_id"]], np.int64)
                raw_best = raw_best.filter(d["alignment_score"] >= floor)
            raw_stat_table = align_stat_by_assembly(raw_best, info, None)

        # noise stack (steps 8-12): named noise sources accumulate
        noise_sources: dict[str, np.ndarray] = {}
        if opt.spike_filter and len(align_list):
            with log.step("spike_filter"):
                bed = spike_filter_bed(align_list, info,
                                       stdev=opt.spike_stdev)
                if len(bed):
                    noise_sources["spike"] = bed
        if opt.human_repetitive_filter and self.human_db is not None \
                and len(align_list):
            with log.step("human_repetitive_filter"):
                bed = self._human_repetitive_bed(align_list)
                if len(bed):
                    noise_sources["human_repetitive"] = bed
        if opt.microbe_repetitive_filter and len(align_list):
            with log.step("microbe_repetitive_filter"):
                bed = self._microbe_repetitive_bed(align_list, info)
                if len(bed):
                    noise_sources["microbe_repetitive"] = bed
        if opt.variable_region_adjustment and len(align_list):
            with log.step("variable_region"):
                bed = self._variable_region_bed(align_list, info)
                if len(bed):
                    noise_sources["variable_region"] = bed

        noise_bed = None
        if noise_sources:
            noise_bed = merge_bed(np.concatenate(list(
                noise_sources.values())))

        # step 13: noise removal (always; no-op without noise)
        n_noise_alignments = 0
        if noise_bed is not None and len(noise_bed) and len(align_list):
            q = make_bed(align_list.data["assembly_id"],
                         align_list.data["sequence_id"],
                         align_list.data["sequence_from"],
                         align_list.data["sequence_to"])
            ov = overlap_bp(q, noise_bed)
            span = (align_list.data["sequence_to"]
                    - align_list.data["sequence_from"])
            keep_mask = ov <= opt.noise_overlap_fraction * span
            n_noise_alignments = int((~keep_mask).sum())
            pre_noise_align = align_list
            align_list = align_list.filter(keep_mask)
        else:
            pre_noise_align = align_list

        # step 14: short alignment removal
        if opt.short_alignment_filter and len(align_list):
            span = (align_list.data["sequence_to"]
                    - align_list.data["sequence_from"])
            align_list = align_list.filter(span >= opt.min_alignment_length)

        # step 16: combine with human/decoy — microbe alignments must beat
        # the read's human/decoy score (megapath_nano.py:2432-2441)
        if (human_as or decoy_as) and len(align_list):
            d = align_list.data
            n_reads_tot = int(d["read_id"].max()) + 1
            floor_by_read = np.zeros(n_reads_tot, np.int64)
            for r, s in human_as.items():
                if r < n_reads_tot:
                    floor_by_read[r] = s
            for r, s in decoy_as.items():
                if r < n_reads_tot:
                    floor_by_read[r] = max(floor_by_read[r], s)
            floor = floor_by_read[d["read_id"]]
            align_list = align_list.filter(d["alignment_score"] >= floor)

        # step 15: closing spike filter — removes whole READS whose best
        # alignment sits in late-detected spikes (megapath_nano.py:2391-2406)
        if opt.closing_spike_filter and len(align_list):
            with log.step("closing_spike_filter"):
                spike2 = spike_filter_bed(align_list, info,
                                          stdev=opt.closing_spike_stdev)
                if len(spike2):
                    pre_best = best_align_list(align_list, info, None)
                    q = make_bed(pre_best.data["assembly_id"],
                                 pre_best.data["sequence_id"],
                                 pre_best.data["sequence_from"],
                                 pre_best.data["sequence_to"])
                    ov = overlap_bp(q, spike2)
                    span = (pre_best.data["sequence_to"]
                            - pre_best.data["sequence_from"])
                    bad_reads = set(
                        pre_best.data["read_id"][
                            ov > opt.noise_overlap_fraction * span].tolist())
                    if bad_reads:
                        keep = np.array([int(r) not in bad_reads
                                         for r in align_list.data["read_id"]])
                        align_list = align_list.filter(keep)

        # step 17: best alignment (abundance-weighted tie-break)
        with log.step("best_alignment"):
            best = best_align_list(align_list, info, noise_bed)

        # step 19: unique alignment (optional) — vectorized top-2 per read
        # over per-(read, assembly) best scores (megapath_nano.py:2561-2590)
        unique_ids = None
        if opt.unique_alignment and len(best):
            d = align_list.data
            o = np.lexsort((-d["alignment_score"], d["assembly_id"],
                            d["read_id"]))
            dd = d[o]
            firstpa = np.append(True, (dd["read_id"][1:] != dd["read_id"][:-1])
                                | (dd["assembly_id"][1:]
                                   != dd["assembly_id"][:-1]))
            pa = dd[firstpa]                    # per-(read, asm) best
            o2 = np.lexsort((-pa["alignment_score"], pa["read_id"]))
            ps = pa[o2]
            newr = np.append(True, ps["read_id"][1:] != ps["read_id"][:-1])
            starts = np.flatnonzero(newr)
            runlen = np.diff(np.append(starts, len(ps)))
            top1_s = ps["alignment_score"][starts].astype(np.int64)
            top1_a = ps["assembly_id"][starts].astype(np.int64)
            top2_s = np.where(runlen > 1, ps["alignment_score"][
                np.minimum(starts + 1, len(ps) - 1)], 0).astype(np.int64)
            read_keys = ps["read_id"][starts].astype(np.int64)
            bd = best.data
            rids_b = bd["read_id"].astype(np.int64)
            best_s = bd["alignment_score"].astype(np.int64)
            best_a = bd["assembly_id"].astype(np.int64)
            pos = np.searchsorted(read_keys, rids_b)
            second = np.where(top1_a[pos] == best_a, top2_s[pos],
                              top1_s[pos])
            if human_as or decoy_as:
                n_tot = int(rids_b.max()) + 1
                hd_floor = np.zeros(n_tot, np.int64)
                for r, s in human_as.items():
                    if r < n_tot:
                        hd_floor[r] = s
                for r, s in decoy_as.items():
                    if r < n_tot:
                        hd_floor[r] = max(hd_floor[r], s)
                second = np.maximum(second, hd_floor[rids_b])
            unique_ids = rids_b[best_s * opt.unique_as_ratio > second]

        with log.step("statistics"):
            stat = align_stat_by_assembly(best, info, noise_bed)
            unique_stat = None
            if unique_ids is not None and len(unique_ids):
                uset = set(unique_ids.tolist())
                umask = np.array([int(r) in uset
                                  for r in best.data["read_id"]])
                unique_stat = align_stat_by_assembly(
                    best.filter(umask), info, noise_bed)
            # step 25: upper-bound abundance over best + noise alignments
            # (max_adjusted_abundance, megapath_nano.py:3183-3202)
            max_stat = None
            if noise_bed is not None and len(noise_bed):
                max_best = best_align_list(pre_noise_align, info, None)
                max_stat = align_stat_by_assembly(max_best, info, None)

        # step 21: similar-species marker (top genera's siblings)
        similar_marks: dict[int, bool] = {}
        if opt.similar_species_marker and len(stat):
            with log.step("similar_species_marker"):
                similar_marks = self._similar_species_marks(stat)

        # step 20: noise projection (simulate reads from top assemblies,
        # measure cross-mapping onto genus siblings)
        projections: list = []
        if opt.noise_projection and len(stat):
            with log.step("noise_projection"):
                projections = self._noise_projections(stat)

        return ProfileResult(
            align_list=align_list, best=best, stat=stat,
            noise_bed=noise_bed, n_reads_in=len(reads),
            n_reads_aligned=n_aligned,
            human_read_ids=human_ids, decoy_read_ids=decoy_ids,
            unique_read_ids=unique_ids,
            human_best=human_best, decoy_best=decoy_best,
            noise_sources=noise_sources,
            n_noise_alignments=n_noise_alignments,
            max_stat=max_stat, similar_marks=similar_marks,
            noise_projections=projections,
            selected_assembly_list=selected_assemblies,
            raw_stat=raw_stat_table, id_stat=id_stat_table,
            unique_stat=unique_stat, pre_noise_best=raw_best,
            human_stat=(align_stat_by_sequence(
                human_best, self.human_db.index.seq_lengths)
                if human_best is not None and len(human_best) else None),
            decoy_stat=(align_stat_by_sequence(
                decoy_best, self.decoy_db.index.seq_lengths)
                if decoy_best is not None and len(decoy_best) else None),
            assembly_names=result_asm_names,
            sequence_names=result_seq_names,
            sequence_lengths=result_seq_lens)

    # -- genome-vs-genome helpers ----------------------------------------
    def _assembly_seqs(self, db: RefDB, assembly_id: int):
        idx = db.index
        sa = db.seq_assembly
        out = []
        for sid in np.flatnonzero(sa == assembly_id):
            s0 = int(idx.seq_offsets[sid])
            s1 = int(idx.seq_offsets[sid + 1])
            out.append(idx.seq_data[s0:s1])
        return out

    def _human_repetitive_bed(self, align_list: AlignList):
        """Step 10: align the human genome against the selected assemblies'
        index; covered regions become noise (megapath_nano.py:1809-1932)."""
        from megapath_nano_tpu_torch.taxon.genome_filters import \
            human_repetitive_bed

        human_seqs = []
        hidx = self.human_db.index
        for sid in range(len(hidx.seq_names)):
            s0 = int(hidx.seq_offsets[sid])
            s1 = int(hidx.seq_offsets[sid + 1])
            human_seqs.append(hidx.seq_data[s0:s1])
        key = "+".join(self.human_db.assembly_names) + ":" \
            + "+".join(self.db.assembly_names)
        return human_repetitive_bed(
            human_seqs, self.db.index, self.db.seq_assembly,
            device=self.device,
            cache=self._bed_cache, cache_key=key)

    def _microbe_repetitive_bed(self, align_list: AlignList, info):
        """Step 12: abundance-ratio ladder between present assemblies
        (megapath_nano.py:1968-2246)."""
        from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
        from megapath_nano_tpu_torch.taxon.genome_filters import \
            microbe_repetitive_beds

        opt = self.options
        pre_stat = align_stat_by_assembly(align_list, info, None)
        abundances = {int(r["assembly_id"]): float(r["adjusted_total_aligned_bp"])
                      for r in pre_stat}
        depth_of = {int(r["assembly_id"]): float(r["adjusted_average_depth"])
                    for r in pre_stat}
        # cap to the top assemblies to bound pairwise work
        top = sorted(abundances, key=lambda a: -abundances[a])[:8]
        abundances = {a: abundances[a] for a in top}
        assemblies = {a: self._assembly_seqs(self.db, a) for a in top}
        genus_of = {a: int(self.db.assembly_tax[a, 2]) for a in top}
        idx_of = {}
        sa_of = {}
        for a in top:
            seqs = assemblies[a]
            idx_of[a] = MinimizerIndex.build(
                seqs, [f"a{a}s{i}" for i in range(len(seqs))])
            sa_of[a] = np.full(len(seqs), a, np.int32)
        t80, t90, t95, t98, t99, t992 = opt.microbe_rep_thresholds
        ladder = [(t80, 0.80, False), (t90, 0.90, False), (t95, 0.95, False),
                  (t98, 0.98, True), (t99, 0.99, True), (t992, 0.992, True)]
        bed = microbe_repetitive_beds(
            assemblies, abundances, genus_of, idx_of, sa_of,
            device=self.device,
            cache=self._bed_cache,
            name_of={a: self.db.assembly_names[a] for a in top},
            targeted_max_span=opt.microbe_rep_targeted_max_span,
            allowed_max_span=opt.microbe_rep_allowed_max_span,
            ratio_ladder=ladder, depth_of=depth_of,
            min_source_depth=opt.microbe_rep_min_average_depth)
        if len(bed):
            # sequence ids in the per-assembly indexes are local; map back to
            # global sequence ids of the main db
            for a in top:
                local = bed["assembly_id"] == a
                if local.any():
                    global_ids = np.flatnonzero(self.db.seq_assembly == a)
                    bed["sequence_id"][local] = global_ids[
                        bed["sequence_id"][local]]
        return bed

    def _variable_region_bed(self, align_list: AlignList, info):
        """Step 8: within each species with multiple DB assemblies, regions
        of the most-aligned assembly not shared by >=50% of its sibling
        strains become noise (megapath_nano.py:1572-1758)."""
        from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
        from megapath_nano_tpu_torch.taxon.genome_filters import \
            variable_region_bed
        from megapath_nano_tpu_torch.taxon.intervals import (
            BED_DTYPE, merge_bed)

        pre_stat = align_stat_by_assembly(align_list, info, None)
        beds = []
        species_seen = set()
        for row in pre_stat[np.argsort(
                -pre_stat["adjusted_total_aligned_bp"], kind="stable")]:
            sp = int(row["species_tax_id"])
            if sp in species_seen:
                continue
            species_seen.add(sp)
            chosen = int(row["assembly_id"])
            sibs = [a for a in range(len(self.db.assembly_names))
                    if int(self.db.assembly_tax[a, 1]) == sp]
            if len(sibs) < 2:
                continue
            strain_seqs = {a: self._assembly_seqs(self.db, a) for a in sibs}
            chosen_seqs = strain_seqs[chosen]
            tindex = MinimizerIndex.build(
                chosen_seqs, [f"c{i}" for i in range(len(chosen_seqs))])
            bed = variable_region_bed(
                strain_seqs, tindex, np.zeros(len(chosen_seqs), np.int32),
                chosen, device=self.device,
                min_strain_fraction=self.options.variable_region_percent,
                cache=self._bed_cache,
                cache_key="+".join(sorted(
                    self.db.assembly_names[a] for a in sibs))
                + f"->{self.db.assembly_names[chosen]}")
            if len(bed):
                # map local sequence ids back to global
                global_ids = np.flatnonzero(self.db.seq_assembly == chosen)
                bed["sequence_id"] = global_ids[bed["sequence_id"]]
                bed["assembly_id"] = chosen
                beds.append(bed)
        if not beds:
            return np.zeros(0, BED_DTYPE)
        return merge_bed(np.concatenate(beds))

    def _noise_projections(self, stat) -> list:
        """Step 20: simulate reads from the top genera's dominant assemblies
        and measure cross-mapping onto genus siblings
        (megapath_nano.py:2596-2749)."""
        from megapath_nano_tpu_torch.taxon.noise_projection import (
            project_noise)

        opt = self.options
        order = np.argsort(-stat["adjusted_total_aligned_bp"], kind="stable")
        projections = []
        genera_done = set()
        for row in stat[order]:
            g = int(row["genus_tax_id"])
            if g in genera_done:
                continue
            genera_done.add(g)
            if len(genera_done) > opt.noise_projection_num_genus:
                break
            # every genus member with >= min_percent_abundance of the
            # genus top acts as a simulation source (reference :2661-2672)
            genus_rows = stat[stat["genus_tax_id"] == g]
            top_ab = float(row["adjusted_total_aligned_bp"])
            min_ab = top_ab * opt.noise_projection_min_percent_abundance \
                / 100.0
            sources = genus_rows[
                genus_rows["adjusted_total_aligned_bp"] >= min_ab]
            for srow in sources:
                src = int(srow["assembly_id"])
                sibs = {a: self._assembly_seqs(self.db, a)
                        for a in range(len(self.db.assembly_names))
                        if int(self.db.assembly_tax[a, 2]) == g and a != src}
                if not sibs:
                    continue
                # read length cap = multiplier x the source's average read
                # length, rounded to the simulation length bin
                # (megapath_nano.py:2675-2677, default 0.5 / 1000)
                avg_len = float(srow["average_read_length"]) or 1000.0
                mult = opt.noise_projection_read_length_multiplier
                bsz = max(int(opt.noise_projection_length_bin_size), 1)
                max_len = int((avg_len * mult + bsz / 2) // bsz) * bsz
                max_len = max(max_len, bsz)
                projections.extend(project_noise(
                    src, self._assembly_seqs(self.db, src), sibs,
                    n_reads=opt.noise_projection_reads,
                    max_read_length=max_len,
                    device=self.device))
        return projections

    def _similar_species_marks(self, stat) -> dict[int, bool]:
        """Step 21: within each of the top genera, mark assemblies similar
        to the genus-dominant assembly (megapath_nano.py:2756-2943)."""
        from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
        from megapath_nano_tpu_torch.taxon.genome_filters import \
            similar_species_marker

        order = np.argsort(-stat["adjusted_total_aligned_bp"], kind="stable")
        top_genera = []
        for row in stat[order]:
            g = int(row["genus_tax_id"])
            if g not in top_genera:
                top_genera.append(g)
            if len(top_genera) >= self.options.similar_marker_num_genus:
                break
        marks: dict[int, bool] = {}
        for g in top_genera:
            rows = stat[stat["genus_tax_id"] == g]
            if len(rows) == 0:
                continue
            rows = rows[np.argsort(-rows["adjusted_total_aligned_bp"],
                                   kind="stable")]
            top_asm = int(rows[0]["assembly_id"])
            # siblings: every OTHER assembly of this genus in the database
            # (the reference aligns against the genus genome set, not just
            # assemblies with reads — megapath_nano.py:2818-2938)
            sibs = [a for a in range(len(self.db.assembly_names))
                    if int(self.db.assembly_tax[a, 2]) == g and a != top_asm]
            if not sibs:
                continue
            sib_seqs, sib_sa, sib_lens = [], [], {}
            for a in sibs:
                seqs = self._assembly_seqs(self.db, a)
                for s in seqs:
                    sib_seqs.append(s)
                    sib_sa.append(a)
                sib_lens[a] = int(sum(len(s) for s in seqs))
            if not sib_seqs:
                continue
            sib_index = MinimizerIndex.build(
                sib_seqs, [f"s{i}" for i in range(len(sib_seqs))])
            got = similar_species_marker(
                self._assembly_seqs(self.db, top_asm), sib_index,
                np.array(sib_sa, np.int32), sib_lens,
                cond1=self.options.similar_marker_cond1,
                cond2=self.options.similar_marker_cond2,
                combine=self.options.similar_marker_combine,
                device=self.device)
            marks.update(got)
        return marks

    def write_reports(self, result: ProfileResult, out_dir: str,
                      prefix: str = "out",
                      read_lengths: np.ndarray | None = None,
                      read_quals: np.ndarray | None = None,
                      reads: list | None = None,
                      archive_format: str = "gztar",
                      enabled: set | None = None) -> dict:
        """Full output surface (step 27, megapath_nano.py:3275-3888):
        .genome_set, .per_read archive (read/human/decoy/id/raw/list/
        microbe/unique/noise lists), .quality_score/.read_length archives,
        .read_stat, .human_stat/.decoy_stat (per sequence), .id_stat/
        .raw_stat, .microbe_stat (+pre-noise columns + similar-species
        marker), .unique_stat, .preport, .read_count_by_name,
        .microbe_stat_by_sequence_id, .bam_filter/.bam_filter_good,
        .noise.bed + per-source beds + .noise archive (noise_stat /
        noise_source_stat), .species.sam/.paf.

        enabled: None writes everything; otherwise a set of output-group
        keys mirroring the reference's --output_* toggles (genome_set,
        id_signal, raw_signal, human_stat, decoy_stat, noise_stat,
        separate_noise_bed, per_read_data, read_length_histogram,
        quality_score_histogram, PAF)."""

        def on(key: str) -> bool:
            return enabled is None or key in enabled
        import shutil
        import tempfile

        from megapath_nano_tpu_torch.report.writers import (
            write_align_list_tsv, write_bed_tsv, write_genome_set,
            write_stat_table)
        from megapath_nano_tpu_torch.taxon.assembly_selection import \
            good_align_list
        from megapath_nano_tpu_torch.taxon.noise_stats import (
            noise_removal_stats, noise_source_stats)

        os.makedirs(out_dir, exist_ok=True)
        fp = os.path.join(out_dir, prefix)
        paths = {
            "preport": fp + ".preport",
            "microbe_stat": fp + ".microbe_stat",
            "read_stat": fp + ".read_stat",
        }
        asm_names = result.assembly_names
        best = result.best
        human_set = set(result.human_read_ids.tolist()
                        if result.human_read_ids is not None else [])
        decoy_set = set(result.decoy_read_ids.tolist()
                        if result.decoy_read_ids is not None else [])
        micro_ids = (np.unique(best.data["read_id"]).astype(np.int64)
                     if len(best) else np.zeros(0, np.int64))
        micro_set = set(micro_ids.tolist())

        # .preport + main per-assembly table (pre-noise + marker columns)
        write_preport(paths["preport"], result.stat, self.db.tax_names)
        pre_stat = {int(r["assembly_id"]): r for r in result.id_stat} \
            if result.id_stat is not None else {}
        write_microbe_stat(paths["microbe_stat"], result.stat, asm_names,
                           pre_stat=pre_stat,
                           similar_marks=result.similar_marks)

        # .genome_set (assembly_info table, ref :3335)
        if on("genome_set"):
            paths["genome_set"] = fp + ".genome_set"
            write_genome_set(paths["genome_set"], asm_names,
                             result.stat, self.db)

        # stage stat tables
        gate_of = {"id_stat": "id_signal", "raw_stat": "raw_signal"}
        for key, table in [("id_stat", result.id_stat),
                           ("raw_stat", result.raw_stat),
                           ("unique_stat", result.unique_stat)]:
            if not on(gate_of.get(key, key)):
                continue
            if table is not None:
                paths[key] = fp + f".{key}"
                write_stat_table(paths[key], table, asm_names)
        if result.human_stat is not None and self.human_db is not None \
                and on("human_stat"):
            paths["human_stat"] = fp + ".human_stat"
            write_stat_table(paths["human_stat"], result.human_stat,
                             list(self.human_db.index.seq_names))
        if result.decoy_stat is not None and self.decoy_db is not None \
                and on("decoy_stat"):
            paths["decoy_stat"] = fp + ".decoy_stat"
            write_stat_table(paths["decoy_stat"], result.decoy_stat,
                             list(self.decoy_db.index.seq_names))
        if result.max_stat is not None:
            paths["max_adjusted_abundance"] = fp + ".max_adjusted_abundance"
            write_stat_table(paths["max_adjusted_abundance"],
                             result.max_stat, asm_names)

        # per-sequence microbe stat (ref :3680 by_sequence_id)
        if len(best):
            from megapath_nano_tpu_torch.taxon.abundance import \
                align_stat_by_sequence
            seq_lens = result.sequence_lengths \
                if result.sequence_lengths is not None \
                else self.db.index.seq_lengths
            paths["microbe_stat_by_sequence_id"] = \
                fp + ".microbe_stat_by_sequence_id"
            write_stat_table(paths["microbe_stat_by_sequence_id"],
                             align_stat_by_sequence(best, seq_lens),
                             result.sequence_names)

            # .read_count_by_name (ref :3668-3673)
            paths["read_count_by_name"] = fp + ".read_count_by_name"
            sid, cnt = np.unique(best.data["sequence_id"],
                                 return_counts=True)
            with open(paths["read_count_by_name"], "w") as f:
                f.write("sequence_name\tread_count\n")
                order = np.argsort(-cnt, kind="stable")
                for i in order:
                    name = result.sequence_names[int(sid[i])] \
                        if int(sid[i]) < len(result.sequence_names) \
                        else str(int(sid[i]))
                    f.write(f"{name}\t{int(cnt[i])}\n")

            # .bam_filter / .bam_filter_good (ref :3713-3721)
            paths["bam_filter"] = fp + ".bam_filter"
            write_align_list_tsv(paths["bam_filter"], best)
            paths["bam_filter_good"] = fp + ".bam_filter_good"
            write_align_list_tsv(paths["bam_filter_good"],
                                 good_align_list(result.align_list, 0.8))

        # read_stat: reference's 14-column totals (ref :44-47, :3395)
        n_in = result.n_reads_in
        rl = read_lengths if read_lengths is not None \
            else np.zeros(n_in, np.int64)
        aligned_set = micro_set | human_set | decoy_set
        amask = np.array([i in aligned_set for i in range(n_in)], bool) \
            if n_in else np.zeros(0, bool)
        hmask = np.array([i in human_set for i in range(n_in)], bool) \
            if n_in else np.zeros(0, bool)
        dmask = np.array([i in decoy_set for i in range(n_in)], bool) \
            if n_in else np.zeros(0, bool)
        mmask = np.array([i in micro_set for i in range(n_in)], bool) \
            if n_in else np.zeros(0, bool)
        with open(paths["read_stat"], "w") as f:
            cols = ["total_number_of_read", "passed_filter", "aligned",
                    "human_read", "decoy_read", "microbe_read", "unaligned",
                    "total_read_bp", "total_passed_filter_read_bp",
                    "total_aligned_read_bp", "total_human_read_bp",
                    "total_decoy_read_bp", "total_microbe_read_bp",
                    "total_unaligned_read_bp"]
            vals = [n_in, n_in, int(amask.sum()), int(hmask.sum()),
                    int(dmask.sum()), int(mmask.sum()),
                    n_in - int(amask.sum()), int(rl.sum()), int(rl.sum()),
                    int(rl[amask].sum()), int(rl[hmask].sum()),
                    int(rl[dmask].sum()), int(rl[mmask].sum()),
                    int(rl[~amask].sum()) if n_in else 0]
            f.write("\t".join(cols) + "\n")
            f.write("\t".join(str(v) for v in vals) + "\n")

        # noise outputs: beds, per-source removal stats, source attribution
        if result.noise_bed is not None and len(result.noise_bed):
            paths["noise_bed"] = fp + ".noise.bed"
            write_bed_tsv(paths["noise_bed"], result.noise_bed,
                          result.sequence_names, asm_names)
        for source, bed in result.noise_sources.items():
            if len(bed) and on("separate_noise_bed"):
                paths[f"{source}_noise_bed"] = fp + f".{source}_noise.bed"
                write_bed_tsv(paths[f"{source}_noise_bed"], bed,
                              result.sequence_names, asm_names)
        if result.pre_noise_best is not None and len(result.pre_noise_best) \
                and on("noise_stat"):
            ntmp = tempfile.mkdtemp(prefix="noise_out_")
            table, all_mask = noise_removal_stats(
                result.pre_noise_best, result.noise_sources,
                result.noise_bed,
                min_align_length=self.options.min_alignment_length,
                overlap_fraction=self.options.noise_overlap_fraction)
            with open(os.path.join(ntmp, f"{prefix}.noise_stat"),
                      "w") as f:
                from megapath_nano_tpu_torch.taxon.intervals import \
                    covered_bp_by_assembly
                sources = ["spike", "human_repetitive",
                           "microbe_repetitive", "closing_spike",
                           "variable_region", "noise", "short", "all"]
                # step 22 span columns: per-source noise span bp on each
                # assembly + total span percent (megapath_nano.py:2944-3008)
                span_by = {s: covered_bp_by_assembly(b)
                           for s, b in result.noise_sources.items()}
                total_span = covered_bp_by_assembly(result.noise_bed) \
                    if result.noise_bed is not None else {}
                asm_len = {int(r["assembly_id"]): int(r["assembly_length"])
                           for r in result.stat}
                if result.raw_stat is not None:
                    for r in result.raw_stat:
                        asm_len.setdefault(int(r["assembly_id"]),
                                           int(r["assembly_length"]))
                f.write("assembly_id\t" + "\t".join(
                    f"{s}_{c}" for s in sources
                    for c in ("read_count", "read_bp", "aligned_bp"))
                    + "\t" + "\t".join(f"{s}_span_bp"
                                         for s in result.noise_sources)
                    + "\tnoise_span_bp\tnoise_span_percent\n")
                for aid in sorted(table):
                    name = asm_names[aid] if aid < len(asm_names) \
                        else str(aid)
                    row = [name]
                    for s in sources:
                        row += [str(v) for v in table[aid].get(s, (0, 0, 0))]
                    for s in result.noise_sources:
                        row.append(str(span_by[s].get(aid, 0)))
                    span = total_span.get(aid, 0)
                    length = asm_len.get(aid, 0)
                    row.append(str(span))
                    row.append(f"{span / length:.6f}" if length else "0")
                    f.write("\t".join(row) + "\n")
            noise_best = result.pre_noise_best.filter(all_mask)
            rows = noise_source_stats(
                noise_best, best,
                human_read_ids=result.human_read_ids,
                decoy_read_ids=result.decoy_read_ids)
            with open(os.path.join(ntmp, f"{prefix}.noise_source_stat"),
                      "w") as f:
                f.write("target_assembly_id\tsource_assembly_id"
                        "\tnoise_read_count\tnoise_aligned_bp"
                        "\tnoise_read_bp\n")
                for t, s, c, ab, rb in rows:
                    tn = asm_names[t] if t < len(asm_names) else str(t)
                    sn = asm_names[s] if isinstance(s, (int, np.integer)) \
                        and s < len(asm_names) else str(s)
                    f.write(f"{tn}\t{sn}\t{c}\t{ab}\t{rb}\n")
            if result.similar_marks:
                with open(os.path.join(ntmp, f"{prefix}.similar_region"),
                          "w") as f:
                    f.write("assembly_id\tsimilar_to_genus_top\n")
                    for aid, mark in sorted(result.similar_marks.items()):
                        name = asm_names[aid] if aid < len(asm_names) \
                            else str(aid)
                        f.write(f"{name}\t{int(bool(mark))}\n")
            paths["noise_archive"] = shutil.make_archive(
                fp + ".noise", format=archive_format, root_dir=ntmp)
            shutil.rmtree(ntmp)
        if result.similar_marks:
            paths["similar_species"] = fp + ".similar_species"
            with open(paths["similar_species"], "w") as f:
                f.write("assembly_id\tsimilar_to_genus_top\n")
                for aid, mark in sorted(result.similar_marks.items()):
                    name = asm_names[aid] if aid < len(asm_names) \
                        else str(aid)
                    f.write(f"{name}\t{int(bool(mark))}\n")
        if result.noise_projections:
            paths["noise_projection"] = fp + ".noise_projection"
            with open(paths["noise_projection"], "w") as f:
                f.write("source_assembly\ttarget_assembly\tsimulated_reads"
                        "\tprojected_noise_reads\tprojected_noise_bp\n")
                for pr in result.noise_projections:
                    sn = asm_names[pr.source_assembly]
                    tn = asm_names[pr.target_assembly]
                    f.write(f"{sn}\t{tn}\t{pr.simulated_reads}"
                            f"\t{pr.projected_noise_reads}"
                            f"\t{pr.projected_noise_bp}\n")
        # steps 4-6 product: per-species chosen assembly
        if result.selected_assembly_list:
            paths["assembly_selection"] = fp + ".assembly_selection"
            with open(paths["assembly_selection"], "w") as f:
                f.write("species_tax_id\tassembly\n")
                for sp, aid in sorted(result.selected_assembly_list.items()):
                    name = asm_names[aid] if aid < len(asm_names) \
                        else str(aid)
                    f.write(f"{sp}\t{name}\n")

        # per-read archive (ref :3345-3360)
        if on("per_read_data"):
            ptmp = tempfile.mkdtemp(prefix="per_read_out_")
            pp = os.path.join(ptmp, prefix)
            with open(pp + ".read_list", "w") as f:
                f.write("read_id\tread_length\tpassed_filter\taligned"
                        "\thuman_read\tdecoy_read\tmicrobe_read\n")
                for rid in range(n_in):
                    f.write(
                        f"{rid}\t{int(rl[rid]) if rid < len(rl) else 0}\t1"
                        f"\t{int(rid in aligned_set)}"
                        f"\t{int(rid in human_set)}"
                        f"\t{int(rid in decoy_set)}"
                        f"\t{int(rid in micro_set)}\n")
            listed = [("microbe_list", best), ("list", result.align_list)]
            if result.human_best is not None:
                listed.append(("human_list", result.human_best))
            if result.decoy_best is not None:
                listed.append(("decoy_list", result.decoy_best))
            if result.pre_noise_best is not None:
                listed.append(("raw_list", result.pre_noise_best))
                table2, all_mask2 = noise_removal_stats(
                    result.pre_noise_best, result.noise_sources,
                    result.noise_bed,
                    min_align_length=self.options.min_alignment_length,
                    overlap_fraction=self.options.noise_overlap_fraction)
                listed.append(("noise_list",
                               result.pre_noise_best.filter(all_mask2)))
            if result.unique_read_ids is not None and len(best):
                uset = set(result.unique_read_ids.tolist())
                umask = np.array([int(r) in uset
                                  for r in best.data["read_id"]])
                listed.append(("unique_list", best.filter(umask)))
            for name, al in listed:
                write_align_list_tsv(pp + f".{name}", al)
            paths["per_read_archive"] = shutil.make_archive(
                fp + ".per_read", format=archive_format, root_dir=ptmp)
            shutil.rmtree(ptmp)

        # alignment record outputs (.species.sam/.paf, lib/aligner.py:245-261)
        if reads is not None and len(result.best) and on("PAF"):
            from megapath_nano_tpu_torch.report.samout import (
                write_paf, write_sam)

            paths["species_paf"] = fp + ".species.paf"
            write_paf(paths["species_paf"], result.best)
            # SAM needs real CIGARs — only written when the run mapped with
            # emit_cigars (PAF-only runs skip it rather than emit fake Ms)
            if result.best.cigar_map is not None:
                paths["species_sam"] = fp + ".species.sam"
                write_sam(paths["species_sam"], result.best, reads,
                          result.sequence_lengths
                          if result.sequence_lengths is not None
                          else self.db.index.seq_lengths)

        # per-category length/quality archives (7 categories, ref :3362-3392)
        if read_lengths is not None:
            from megapath_nano_tpu_torch.report.histograms import (
                write_histograms)

            def cat(mask):
                ids = np.flatnonzero(mask)
                return {
                    "lengths": read_lengths[ids] if len(ids) else
                    np.zeros(0),
                    "quals": (read_quals[ids]
                              if read_quals is not None and len(ids)
                              else None)}
            cats = {
                "all": {"lengths": read_lengths, "quals": read_quals},
                "passed": {"lengths": read_lengths, "quals": read_quals},
                "human": cat(hmask), "decoy": cat(dmask),
                "microbe": cat(mmask), "aligned": cat(amask),
                "unaligned": cat(~amask if n_in else amask),
            }
            htmp = tempfile.mkdtemp(prefix="hist_out_")
            hp = write_histograms(htmp, prefix, cats,
                                  length_bin=self._length_bin,
                                  quality_bin=self._quality_bin)
            for kind in ("read_length", "quality_score"):
                if not on(f"{kind}_histogram"):
                    continue
                ktmp = tempfile.mkdtemp(prefix=f"{kind}_out_")
                shutil.copy(hp[kind], ktmp)
                paths[f"{kind}_archive"] = shutil.make_archive(
                    fp + f".{kind}", format=archive_format, root_dir=ktmp)
                shutil.rmtree(ktmp)
            shutil.rmtree(htmp)
        return paths

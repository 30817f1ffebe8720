"""mpn-torch CLI: taxonomic profiling + AMR from a FASTQ, on the GPU.

User-facing driver mirroring the reference's CLI surface
(reference: bin/megapath_nano.py:4831-5146 argparse; usage README.md:111:
`python megapath_nano.py --query reads.fq [options]`). Flag names match the
reference where the concept carries over.

  python -m megapath_nano_tpu_torch.cli.main \
      --query reads.fastq --db <refdb_dir> --output_folder out/ \
      [--output_prefix p] [--reassignment] [--spike_filter] ...

Build a RefDB first with `python -m megapath_nano_tpu_torch.cli.build_db`
(a DB saved by megapath_nano_tpu loads as it is).

The port's own copy of megapath_nano_tpu/cli/main.py, with the same flags
and dests except one: `--backend` becomes `--device {cuda,cpu}` (default
cuda; every map of the run goes to that device, the index shards of
`--index_shards` and the AMR scans of `--amr_db` included, and the default
raises without a CUDA device).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpn-torch",
        description="Long-read metagenomics on the GPU: taxonomic "
                    "profiling and AMR detection")
    p.add_argument("--query", required=True, action="append",
                   help="input FASTQ/FASTA(.gz); repeatable")
    p.add_argument("--db", required=True, help="RefDB directory")
    p.add_argument("--genome_set",
                   help="file listing assembly names to restrict the DB to "
                        "(the reference's config/ genome sets)")
    p.add_argument("--human_db", help="human-genome RefDB directory")
    p.add_argument("--decoy_db", help="decoy RefDB directory")
    p.add_argument("--amr_db", action="append", default=[],
                   help="AMR gene DB directory (repeatable)")
    p.add_argument("--output_folder", default=".")
    p.add_argument("--output_prefix", default=None)

    # read filter (reference defaults, megapath_nano.py:5061-5068).
    # --min_read_quality/--min_read_length are the reference's names;
    # the read_filter_* spellings are kept as aliases
    p.add_argument("--min_read_quality", "--read_filter_min_quality",
                   dest="read_filter_min_quality", type=float, default=7.0)
    p.add_argument("--min_read_length", "--read_filter_min_length",
                   dest="read_filter_min_length", type=int, default=0)
    p.add_argument("--head_crop", type=int, default=0)
    p.add_argument("--tail_crop", type=int, default=0)

    def gate(name, default=False):
        p.add_argument(f"--{name}", dest=name, action="store_true")
        p.add_argument(f"--no_{name}", dest=name, action="store_false")
        p.set_defaults(**{name: default})

    gate("adaptor_trimming", True)   # reference: on (megapath_nano.py:4982)
    gate("read_filter", True)
    gate("human_filter", False)
    gate("decoy_filter", False)
    gate("reassignment", False)
    gate("spike_filter", False)
    gate("closing_spike_filter", False)
    gate("short_alignment_filter", False)
    gate("unique_alignment", False)
    gate("variable_region_adjustment", False)
    gate("human_repetitive_region_filter", False)
    gate("microbe_repetitive_region_filter", False)
    gate("similar_species_marker", False)
    gate("noise_projection", False)
    gate("amplicon_filter_module", False)
    gate("amr", True)
    gate("assembly_selection", False)   # steps 4-6 (reference :4987)
    gate("read_trimming", True)         # head/tail crop applies (:4983)
    gate("reassign_read_id", False)     # sequential read ids (:5004)
    # stage subsets (reference :4893-4905, :4185-4186)
    gate("mapping_only", False)         # stop after placement (.species.*)
    gate("filter_fq_only", False)       # stop after QC; write filtered fq
    gate("all_taxon_module_steps", True)  # False == filter_fq_only (:4185)
    p.add_argument("--taxon_module_only", action="store_true",
                   help="skip the AMR module (reference module_option "
                        "taxon_module)")
    # output toggles (reference defaults :5007-5023)
    gate("output_PAF", True)
    gate("output_noise_stat", True)
    gate("output_separate_noise_bed", True)
    gate("output_human_stat", True)
    gate("output_decoy_stat", True)
    gate("output_id_signal", True)
    gate("output_raw_signal", True)
    gate("output_per_read_data", True)
    gate("output_quality_score_histogram", True)
    gate("output_read_length_histogram", True)
    gate("output_genome_set", True)
    gate("output_trimmed_and_filtered_query", False)
    p.add_argument("--archive_format", choices=["gztar", "tar", "zip"],
                   default="gztar",
                   help="format of the .per_read/.noise/... archives "
                        "(reference :5130)")
    p.add_argument("--read_length_bin_size", type=int, default=None,
                   help="fixed-width read-length histogram bins "
                        "(reference default 100; None = log-ish edges)")
    p.add_argument("--quality_score_bin_size", type=float, default=None,
                   help="quality histogram bin width (reference default "
                        "0.2; None = 1-phred bins)")
    p.add_argument("--max_aligner_thread", type=int, default=None,
                   help="native-layer thread cap (index build, host "
                        "seeding; default: all cores; reference :5049)")
    p.add_argument("--debug", action="store_true",
                   help="verbose step logging to stderr (reference keeps "
                        "temp files; this design has no temp files)")

    p.add_argument("--assembly_db",
                   help="assembly-ID genome set RefDB (extra candidate "
                        "assemblies for --assembly_selection)")
    p.add_argument("--assembly_id_min_average_depth", type=float,
                   default=0.5)
    p.add_argument("--good_alignment_threshold", type=int, default=80)
    p.add_argument("--genome_pair_cache",
                   help="directory for cached genome-pair filter BEDs "
                        "(incremental noise-stack reruns)")
    p.add_argument("--amr_organism",
                   help="organism name enabling taxon-restricted AMR genes "
                        "(AMRFinder --taxon equivalent)")
    p.add_argument("--amr_protein_db",
                   help="CBMAR-style protein DB directory for the "
                        "ORF/blastp scan")
    p.add_argument("--min_alignment_length", type=int, default=0)
    p.add_argument("--min_alignment_score", type=int, default=0,
                   help="min alignment score (reference :5062)")
    p.add_argument("--human_filter_alignment_score", type=int, default=1000)
    p.add_argument("--human_filter_alignment_score_percent", type=float,
                   default=100.0)

    # noise-stack tunables (reference names + defaults,
    # megapath_nano.py:5077-5128)
    p.add_argument("--species_id_min_aligned_bp", type=int, default=0,
                   help="min aligned bp to include a species (:5077)")
    p.add_argument("--variable_region_percent", type=int, default=50,
                   help="max %% of strains aligned for a region to be "
                        "variable (:5084)")
    p.add_argument("--expected_max_depth_stdev", type=float, default=6.0,
                   help="stdevs over mean depth for the spike filter "
                        "(:5087)")
    p.add_argument("--closing_expected_max_depth_stdev", type=float,
                   default=9.0, help="spike stdevs, closing pass (:5109)")
    p.add_argument("--max_alignment_noise_overlap", type=int, default=50,
                   help="max %% noise overlap before an alignment is "
                        "removed (:5103)")
    p.add_argument("--unique_alignment_threshold", type=int, default=80,
                   help="unique reads have no competitor within this %% of "
                        "the best score (:5112)")
    # reassignment solve tunables (reference lib/reassignment.py:117-118
    # defaults; the reference hardcodes them — exposed here)
    p.add_argument("--reassignment_ratio", type=float, default=0.05)
    p.add_argument("--reassignment_error_rate", type=float, default=0.05)
    p.add_argument("--reassignment_as_threshold", type=float, default=0.0)
    # similar-species marker tunables (:5123-5128)
    p.add_argument("--similar_species_marker_num_genus", type=int, default=3)
    p.add_argument("--similar_species_marker_alignment_similarity_1",
                   type=int, choices=[99, 98, 95, 90, 80], default=98)
    p.add_argument("--similar_species_marker_aligned_region_threshold_1",
                   type=int, default=50)
    p.add_argument("--similar_species_marker_alignment_similarity_2",
                   type=int, choices=[99, 98, 95, 90, 80], default=95)
    p.add_argument("--similar_species_marker_aligned_region_threshold_2",
                   type=int, default=75)
    p.add_argument("--similar_species_marker_similarity_combine_logic",
                   choices=["and", "or"], default="or")
    # noise projection tunables (:5115-5120)
    p.add_argument("--number_of_genus_to_perform_noise_projection",
                   type=int, default=3)
    p.add_argument("--noise_projection_num_read_to_simulate", type=int,
                   default=10000)
    p.add_argument("--noise_projection_simulated_read_length_multiplier",
                   type=float, default=0.5)
    p.add_argument("--min_percent_abundance_to_perform_noise_projection",
                   type=int, default=25,
                   help="min %% of the genus-top abundance for an assembly "
                        "to act as a simulation source (:5116)")
    p.add_argument("--noise_projection_simulated_read_length_bin_size",
                   type=int, default=1000,
                   help="simulated max read length rounds to this bin "
                        "(:5117)")
    # microbe-repetitive ladder tunables (:5090-5098)
    p.add_argument("--microbe_repetitive_region_filter_abundance_threshold_80",
                   type=float, default=160.0)
    p.add_argument("--microbe_repetitive_region_filter_abundance_threshold_90",
                   type=float, default=80.0)
    p.add_argument("--microbe_repetitive_region_filter_abundance_threshold_95",
                   type=float, default=40.0)
    p.add_argument("--microbe_repetitive_region_filter_abundance_threshold_98",
                   type=float, default=16.0)
    p.add_argument("--microbe_repetitive_region_filter_abundance_threshold_99",
                   type=float, default=8.0)
    p.add_argument(
        "--microbe_repetitive_region_filter_abundance_threshold_99_2",
        type=float, default=6.4)
    p.add_argument(
        "--microbe_repetitive_region_filter_targeted_max_span_percent",
        type=float, default=90.0)
    p.add_argument(
        "--microbe_repetitive_region_filter_allowed_max_span_percent",
        type=float, default=97.0)
    p.add_argument("--microbe_repetitive_region_filter_min_average_depth",
                   type=float, default=0.2)
    p.add_argument("--max_aligned_reads", type=int, default=0,
                   help="0 = no cap")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of every map: cuda (the kernels; the "
                        "default) or cpu (their plain PyTorch versions)")
    p.add_argument("--index_shards", type=int, default=1,
                   help="partition the reference index into N shards "
                        "(multi-chip/host layout; 1 = monolithic)")
    return p


def options_from_args(args, *, have_human=False, have_decoy=False,
                      have_assembly=False):
    """Map parsed CLI flags onto ProfileOptions — every reference-named
    tunable lands on its implemented field (tested by
    tests/test_cli.py::test_tunable_flags_reach_options)."""
    from megapath_nano_tpu_torch.align.pipeline import AlignParams
    from megapath_nano_tpu_torch.taxon.profiler import ProfileOptions

    return ProfileOptions(
        human_filter=args.human_filter and have_human,
        decoy_filter=args.decoy_filter and have_decoy,
        human_filter_score=args.human_filter_alignment_score,
        human_filter_score_percent=(
            args.human_filter_alignment_score_percent / 100.0),
        reassignment=args.reassignment,
        reassign_ratio=args.reassignment_ratio,
        reassign_error_rate=args.reassignment_error_rate,
        reassign_as_threshold=args.reassignment_as_threshold,
        spike_filter=args.spike_filter,
        spike_stdev=args.expected_max_depth_stdev,
        closing_spike_filter=args.closing_spike_filter,
        closing_spike_stdev=args.closing_expected_max_depth_stdev,
        short_alignment_filter=args.short_alignment_filter,
        min_alignment_length=args.min_alignment_length,
        noise_overlap_fraction=args.max_alignment_noise_overlap / 100.0,
        min_aligned_bp_per_species=args.species_id_min_aligned_bp,
        unique_alignment=args.unique_alignment,
        unique_as_ratio=args.unique_alignment_threshold / 100.0,
        variable_region_adjustment=args.variable_region_adjustment,
        variable_region_percent=args.variable_region_percent / 100.0,
        human_repetitive_filter=args.human_repetitive_region_filter,
        microbe_repetitive_filter=args.microbe_repetitive_region_filter,
        microbe_rep_thresholds=(
            args.microbe_repetitive_region_filter_abundance_threshold_80,
            args.microbe_repetitive_region_filter_abundance_threshold_90,
            args.microbe_repetitive_region_filter_abundance_threshold_95,
            args.microbe_repetitive_region_filter_abundance_threshold_98,
            args.microbe_repetitive_region_filter_abundance_threshold_99,
            args.microbe_repetitive_region_filter_abundance_threshold_99_2),
        microbe_rep_targeted_max_span=(
            args.microbe_repetitive_region_filter_targeted_max_span_percent
            / 100.0),
        microbe_rep_allowed_max_span=(
            args.microbe_repetitive_region_filter_allowed_max_span_percent
            / 100.0),
        microbe_rep_min_average_depth=(
            args.microbe_repetitive_region_filter_min_average_depth),
        similar_species_marker=args.similar_species_marker,
        similar_marker_num_genus=args.similar_species_marker_num_genus,
        similar_marker_cond1=(
            args.similar_species_marker_alignment_similarity_1 / 100.0,
            args.similar_species_marker_aligned_region_threshold_1 / 100.0),
        similar_marker_cond2=(
            args.similar_species_marker_alignment_similarity_2 / 100.0,
            args.similar_species_marker_aligned_region_threshold_2 / 100.0),
        similar_marker_combine=(
            args.similar_species_marker_similarity_combine_logic),
        noise_projection=args.noise_projection,
        noise_projection_num_genus=(
            args.number_of_genus_to_perform_noise_projection),
        noise_projection_reads=args.noise_projection_num_read_to_simulate,
        noise_projection_read_length_multiplier=(
            args.noise_projection_simulated_read_length_multiplier),
        noise_projection_min_percent_abundance=float(
            args.min_percent_abundance_to_perform_noise_projection),
        noise_projection_length_bin_size=(
            args.noise_projection_simulated_read_length_bin_size),
        amplicon_filter_module=args.amplicon_filter_module,
        assembly_selection=args.assembly_selection and have_assembly,
        assembly_id_min_average_depth=args.assembly_id_min_average_depth,
        good_align_threshold=args.good_alignment_threshold / 100.0,
        genome_pair_cache_dir=args.genome_pair_cache,
        align=AlignParams(min_alignment_score=args.min_alignment_score),
        # CIGARs are only consumed by the AMR consensus and the .species.sam
        # output; the amplicon filter's downstream variant tooling also needs
        # them. Pure taxon runs take the PAF-only device path (faster).
        emit_cigars=bool((args.amr and args.amr_db)
                         or args.amplicon_filter_module),
    )


def output_gates_from_args(args) -> set:
    """The write_reports `enabled` set from the --output_* toggles."""
    gates = set()
    for flag, key in (("output_PAF", "PAF"),
                      ("output_noise_stat", "noise_stat"),
                      ("output_separate_noise_bed", "separate_noise_bed"),
                      ("output_human_stat", "human_stat"),
                      ("output_decoy_stat", "decoy_stat"),
                      ("output_id_signal", "id_signal"),
                      ("output_raw_signal", "raw_signal"),
                      ("output_per_read_data", "per_read_data"),
                      ("output_quality_score_histogram",
                       "quality_score_histogram"),
                      ("output_read_length_histogram",
                       "read_length_histogram"),
                      ("output_genome_set", "genome_set")):
        if getattr(args, flag):
            gates.add(key)
    # ungated outputs are always on
    gates |= {"id_stat", "raw_stat", "unique_stat"}
    return gates


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.taxon_module_only:
        args.amr = False
    if not args.all_taxon_module_steps:
        args.filter_fq_only = True
    if args.debug:
        import logging

        logging.basicConfig(level=logging.DEBUG)
    if args.max_aligner_thread:
        from megapath_nano_tpu_torch.native import lib as native_lib

        native_lib.DEFAULT_THREADS = args.max_aligner_thread

    import numpy as np

    from megapath_nano_tpu_torch.align.pipeline import require_device
    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.io.fastq import read_fastq
    from megapath_nano_tpu_torch.taxon.profiler import (
        ProfileOptions, TaxonProfiler)
    from megapath_nano_tpu_torch.utils.log import Log

    require_device(args.device, "mpn-torch --device")
    log = Log("mpn-torch")
    with log.step("load_db"):
        try:
            db = RefDB.load(args.db)
            human_db = RefDB.load(args.human_db) if args.human_db else None
            decoy_db = RefDB.load(args.decoy_db) if args.decoy_db else None
            assembly_db = (RefDB.load(args.assembly_db)
                           if args.assembly_db else None)
        except FileNotFoundError as e:
            print(f"error: database not found: {e.filename}", file=sys.stderr)
            return 2
        if args.genome_set:
            with open(args.genome_set) as f:
                wanted = [l.strip() for l in f if l.strip()]
            try:
                db = db.subset(wanted)
            except ValueError:
                print("error: genome set matches no assemblies in the DB "
                      f"(available: {', '.join(db.assembly_names[:10])}...)",
                      file=sys.stderr)
                return 2
            log.message(f"genome set: {len(db.assembly_names)} assemblies")

    reads, names = [], []
    lengths, quals = [], []
    with log.step("read_input"):
        for path in args.query:
            batch = read_fastq(
                path,
                head_crop=args.head_crop if args.read_trimming else 0,
                tail_crop=args.tail_crop if args.read_trimming else 0,
                min_length=args.read_filter_min_length,
                min_quality=(args.read_filter_min_quality
                             if args.read_filter else 0.0))
            for i in range(batch.num_reads):
                reads.append(batch.read(i))
                names.append(batch.ids[i])
            lengths.append(batch.lengths())
            quals.append(batch.stats["avg_q_trimmed"])
        if args.max_aligned_reads and len(reads) > args.max_aligned_reads:
            reads = reads[: args.max_aligned_reads]
            names = names[: args.max_aligned_reads]
    if args.adaptor_trimming and reads:
        from megapath_nano_tpu_torch.io.adapters import trim_adapters

        with log.step("adaptor_trimming"):
            tr = trim_adapters(reads, names)
            reads, names = tr.reads, tr.names
            log.message(
                f"adapters: {tr.n_start_trimmed} start / {tr.n_end_trimmed} "
                f"end trimmed, {tr.n_split} split, {tr.n_dropped} dropped")
    log.message(f"{len(reads)} reads pass QC")
    if args.reassign_read_id:
        # nanofastq --reassign_read_id semantics: sequential numeric ids
        names = [str(i) for i in range(len(names))]
    if not reads:
        print("no reads after filtering", file=sys.stderr)
        return 1

    prefix = args.output_prefix or os.path.splitext(
        os.path.basename(args.query[0]))[0]
    os.makedirs(args.output_folder, exist_ok=True)
    if args.filter_fq_only or args.output_trimmed_and_filtered_query:
        from megapath_nano_tpu_torch.io.fastq import write_fastq

        fq_out = os.path.join(args.output_folder,
                              f"{prefix}.trimmed_and_filtered.fastq")
        with log.step("write_filtered_fastq"):
            write_fastq(fq_out, names, reads)
        if args.filter_fq_only:
            log.message(f"filter_fq_only: wrote {fq_out}")
            with open(os.path.join(args.output_folder,
                                   f"{prefix}.timing"), "w") as f:
                f.write(log.timing_table() + "\n")
            return 0

    if args.mapping_only:
        from megapath_nano_tpu_torch.report.samout import write_paf, write_sam

        options = options_from_args(args)
        aligner0 = None
        from megapath_nano_tpu_torch.align.pipeline import MinimizerAligner

        aligner0 = MinimizerAligner(db.index, db.sequence_meta,
                                    options.align, device=args.device)
        with log.step("placement_to_species"):
            # mapping-only runs exist to EXPORT alignments, so emit real
            # CIGARs for the SAM (reference always writes .species.sam)
            al = aligner0.map_reads(reads, names,
                                    slice_size=options.map_slice,
                                    emit_cigars=True)
        paf_path = os.path.join(args.output_folder, f"{prefix}.species.paf")
        write_paf(paf_path, al)
        if al.cigar_map is not None:
            write_sam(os.path.join(args.output_folder,
                                   f"{prefix}.species.sam"),
                      al, reads, db.index.seq_lengths)
        with open(os.path.join(args.output_folder,
                               f"{prefix}.timing"), "w") as f:
            f.write(log.timing_table() + "\n")
        log.message(f"mapping_only: wrote {paf_path}")
        return 0

    options = options_from_args(args, have_human=human_db is not None,
                                have_decoy=decoy_db is not None,
                                have_assembly=assembly_db is not None)
    aligner = None
    if args.index_shards > 1:
        from megapath_nano_tpu_torch.dist.sharded_aligner import (
            ShardedAligner)

        idx = db.index
        seqs = [idx.seq_data[idx.seq_offsets[i]: idx.seq_offsets[i + 1]]
                for i in range(len(idx.seq_names))]
        aligner = ShardedAligner.build(
            seqs, list(idx.seq_names), db.sequence_meta.assembly_idx,
            db.assembly_names, args.index_shards, meta=db.sequence_meta,
            params=options.align, k=idx.k, w=idx.w, device=args.device)
        log.message(f"index sharded {args.index_shards} ways")
    profiler = TaxonProfiler(db, options, human_db=human_db,
                             decoy_db=decoy_db, log=log, aligner=aligner,
                             assembly_db=assembly_db, device=args.device)
    profiler._length_bin = args.read_length_bin_size
    profiler._quality_bin = args.quality_score_bin_size
    result = profiler.profile(reads, names)

    all_lengths = np.array([len(r) for r in reads], np.int64)
    paths = profiler.write_reports(
        result, args.output_folder, prefix,
        read_lengths=all_lengths,
        read_quals=None,
        reads=reads,
        archive_format=args.archive_format,
        enabled=output_gates_from_args(args))

    if args.amr and args.amr_db and len(result.best):
        from megapath_nano_tpu_torch.amr.db import AMRGeneDB
        from megapath_nano_tpu_torch.amr.module import run_amr

        with log.step("amr"):
            dbs = []
            for d in args.amr_db:
                dbs.append(AMRGeneDB.load(d) if os.path.isdir(d)
                           else AMRGeneDB.from_fasta(
                               os.path.splitext(os.path.basename(d))[0], d))
            target_seqs = {}
            idx = db.index
            for seq_id in np.unique(result.best.data["sequence_id"]):
                s0 = int(idx.seq_offsets[seq_id])
                s1 = int(idx.seq_offsets[seq_id + 1])
                target_seqs[int(seq_id)] = idx.seq_data[s0:s1]
            protein_db = None
            if args.amr_protein_db:
                import json as _json

                from megapath_nano_tpu_torch.amr.protein import ProteinDB

                with open(os.path.join(args.amr_protein_db,
                                       "proteins.json")) as f:
                    protein_db = ProteinDB.from_records(
                        "cbmar", _json.load(f))
            amr_res = run_amr(result.best, reads, target_seqs, dbs,
                              device=args.device,
                              organism=args.amr_organism,
                              protein_db=protein_db)
            paths["amr"] = amr_res.write(args.output_folder, prefix)

    with open(os.path.join(args.output_folder, f"{prefix}.timing"), "w") as f:
        f.write(log.timing_table() + "\n")
    log.message("outputs: " + ", ".join(sorted(paths.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())

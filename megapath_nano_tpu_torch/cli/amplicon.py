"""Amplicon variant-calling pipeline driver.

The runMegaPath-Nano-Amplicon.sh equivalent (reference:
bin/runMegaPath-Nano-Amplicon.sh:38-95): QC filter -> keep reads whose BEST
alignment hits the target organism (get_highestAS_read_match_target.py:12-26)
-> align to the single target reference -> variant calling (Clair-ensemble,
AF 0.125) -> local realignment re-genotyping -> final VCF. Idempotent stage
markers (.mpn.done / .call.done) mirror the reference's (.mpn.done etc.,
runMegaPath-Nano-Amplicon.sh:45,63,80).

  python -m megapath_nano_tpu_torch.cli.amplicon \
      --query reads.fastq --target_db <refdb of the amplicon organism> \
      [--screen_db <multi-organism refdb> --target_assembly <name>] \
      [--model model.pkl ...] --output_folder out/ [--device cpu]

The port's own copy of megapath_nano_tpu/cli/amplicon.py, with the same
flags and dests except one: `--backend` becomes `--device {cuda,cpu}`
(default cuda, which raises without a CUDA device; cpu runs the kernels'
plain PyTorch versions). Both profilers (screen, target) and every variant
model run on that device.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mpn-torch-amplicon")
    p.add_argument("--query", required=True)
    p.add_argument("--target_db", required=True)
    p.add_argument("--screen_db",
                   help="optional multi-organism DB for read screening")
    p.add_argument("--target_assembly",
                   help="assembly name in screen_db that reads must best-hit")
    p.add_argument("--model", action="append", default=[],
                   help="trained VariantModel pickle (repeatable; ensemble)")
    p.add_argument("--output_folder", default=".")
    p.add_argument("--output_prefix", default="amplicon")
    p.add_argument("--af", type=float, default=0.125)
    p.add_argument("--min_depth", type=int, default=4)
    p.add_argument("--read_filter_min_quality", type=float, default=7.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the maps and the variant models: cuda "
                        "(the default) or cpu (the kernels' plain PyTorch "
                        "versions)")
    p.add_argument("--realign", action="store_true", default=True)
    p.add_argument("--no_realign", dest="realign", action="store_false")
    return p


def main(argv=None) -> int:
    from megapath_nano_tpu_torch.utils.log import span

    args = build_parser().parse_args(argv)
    with span("cli.amplicon"):
        return run(args)


def run(args) -> int:
    """One run of the CLI on parsed arguments; the exit code."""
    import numpy as np

    from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                        require_device)
    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.io.fastq import read_fastq
    from megapath_nano_tpu_torch.taxon.profiler import (ProfileOptions,
                                                        TaxonProfiler)
    from megapath_nano_tpu_torch.utils.log import Log
    from megapath_nano_tpu_torch.variant.caller import (call_variants,
                                                        call_variants_af,
                                                        write_vcf)
    from megapath_nano_tpu_torch.variant.realign import realign_candidates

    require_device(args.device, "mpn-torch-amplicon --device")
    log = Log("mpn-torch-amplicon")
    out = args.output_folder
    os.makedirs(out, exist_ok=True)

    batch = read_fastq(args.query,
                       min_quality=args.read_filter_min_quality)
    reads = [batch.read(i) for i in range(batch.num_reads)]
    names = batch.ids
    log.message(f"{len(reads)} reads pass QC")

    # screening: keep reads whose BEST alignment hits the target assembly
    if args.screen_db and args.target_assembly:
        with log.step("screen"):
            sdb = RefDB.load(args.screen_db)
            sprof = TaxonProfiler(sdb, ProfileOptions(align=AlignParams()),
                                  log=log, device=args.device)
            sres = sprof.profile(reads, names)
            target_idx = sdb.assembly_names.index(args.target_assembly)
            keep_ids = set(
                int(r["read_id"]) for r in sres.best.data
                if int(r["assembly_id"]) == target_idx)
            reads = [r for i, r in enumerate(reads) if i in keep_ids]
            names = [n for i, n in enumerate(names) if i in keep_ids]
            log.message(f"{len(reads)} reads match {args.target_assembly}")
    marker = os.path.join(out, f"{args.output_prefix}.mpn.done")
    open(marker, "w").close()

    tdb = RefDB.load(args.target_db)
    with log.step("align_to_target"):
        tprof = TaxonProfiler(tdb, ProfileOptions(align=AlignParams()),
                              log=log, device=args.device)
        tres = tprof.profile(reads, names)

    idx = tdb.index
    seq_names = idx.seq_names
    all_calls = []
    with log.step("call_variants"):
        models = []
        if args.model:
            from megapath_nano_tpu_torch.variant.model import VariantModel

            for path in args.model:
                m = VariantModel(device=args.device)
                m.load(path)
                models.append(m)
        else:
            # default: the shipped ensemble (like the reference's bundled
            # Clair checkpoints, runClair-ensemble.sh --chkpnt_fn); the
            # AF-threshold caller remains the fallback when absent
            from megapath_nano_tpu_torch.variant.pretrained import (
                default_ensemble)

            models = default_ensemble(args.device)
            if models:
                log.message(f"using shipped ensemble ({len(models)} models)")
        for sid in np.unique(tres.best.data["sequence_id"]):
            s0 = int(idx.seq_offsets[sid])
            s1 = int(idx.seq_offsets[sid + 1])
            ref_seq = idx.seq_data[s0:s1]
            if models:
                calls = call_variants(tres.best, reads, int(sid), ref_seq,
                                      models, min_af=args.af,
                                      min_depth=args.min_depth)
            else:
                calls = call_variants_af(tres.best, reads, int(sid), ref_seq,
                                         min_af=args.af,
                                         min_depth=args.min_depth)
            if args.realign and calls:
                rc = realign_candidates(tres.best, reads, int(sid), ref_seq,
                                        [c.position for c in calls])
                kept = []
                for c, r in zip(calls, rc):
                    if r.depth == 0:
                        continue
                    if r.alt_support / r.depth >= args.af:
                        c.depth = r.depth
                        c.alt_fraction = r.alt_support / r.depth
                        kept.append(c)
                calls = kept
            all_calls.extend(calls)
    open(os.path.join(out, f"{args.output_prefix}.call.done"), "w").close()

    # overlap-variant post-filter (reference: runClair-ensemble.sh:219-224
    # pipes the merged VCF through clair/post_processing/overlap_variant.py)
    from megapath_nano_tpu_torch.variant.overlap import (
        filter_overlapping_calls)

    n_before = len(all_calls)
    all_calls = filter_overlapping_calls(all_calls)
    if len(all_calls) != n_before:
        log.message(f"overlap filter: {n_before - len(all_calls)} "
                    "conflicting variants removed")

    vcf_path = os.path.join(out, f"{args.output_prefix}.vcf")
    write_vcf(vcf_path, all_calls, seq_names)
    log.message(f"{len(all_calls)} variants -> {vcf_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

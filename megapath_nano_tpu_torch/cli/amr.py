"""Standalone AMR module driver (reference megapath_nano_amr.py parity).

The reference ships the AMR module as its own CLI taking an aligned BAM
(reference: bin/megapath_nano_amr.py:240-255 `--query_bam x.bam
--output_folder d`), spawned both by users and from inside Align()
(bin/lib/aligner.py:251-256). The in-process equivalent here consumes a
SAM/BAM produced by any aligner (including this framework's .species.sam),
rebuilds the per-(read, sequence) alignment table + CIGARs, and runs the
same consensus → multi-DB scan → merge flow as the integrated pipeline
(amr/module.py run_amr).

  python -m megapath_nano_tpu_torch.cli.amr \
      --query_bam aln.bam --db <refdb> --amr_db <amrdb> \
      --output_folder out/ [--amr_organism "Escherichia coli"]

Target sequences come from the RefDB (--db) or a FASTA (--reference).

The port's own copy of megapath_nano_tpu/cli/amr.py, with the same flags
and dests except one: `--backend` becomes `--device {cuda,cpu}` (default
cuda, which raises without a CUDA device; cpu runs the kernels' plain
PyTorch versions).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mpn-torch-amr")
    p.add_argument("--query_bam", "--query_sam", dest="query",
                   required=True, help="aligned SAM or BAM")
    p.add_argument("--db", help="RefDB directory with the target sequences")
    p.add_argument("--reference", help="target FASTA (alternative to --db)")
    p.add_argument("--amr_db", action="append", default=[], required=True,
                   help="AMR gene DB directory (repeatable)")
    p.add_argument("--output_folder", default=".")
    p.add_argument("--output_prefix", default="amr")
    p.add_argument("--amr_organism", default=None)
    p.add_argument("--amr_protein_db", default=None)
    p.add_argument("--min_depth", type=int, default=1)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the gene-DB scans: cuda (the kernels; "
                        "the default) or cpu (their plain PyTorch versions)")
    return p


def alignments_from_sam(path, seq_name_to_id):
    """(reads, align_data_rows, cigar_map) from primary mapped records.

    SAM stores SEQ oriented (reverse-strand records carry the reverse
    complement); reads[] holds the ORIGINAL read (re-complemented back),
    matching the pipeline's cigar_map convention (oriented_from = leading
    soft clip in the oriented frame)."""
    from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE
    from megapath_nano_tpu_torch.io.sam import read_bam, read_sam
    from megapath_nano_tpu_torch.utils.dna import revcomp

    reader = read_bam if path.endswith(".bam") else read_sam
    _refs, records = reader(path)
    reads: list[np.ndarray] = []
    rows = []
    cigar_map: dict = {}
    for rec in records:
        if rec.is_unmapped or rec.is_secondary_or_supplementary:
            continue
        if rec.rname not in seq_name_to_id or rec.seq.size == 0:
            continue
        sid = seq_name_to_id[rec.rname]
        strand = 1 if rec.is_reverse else 0
        oriented = rec.seq
        read = revcomp(oriented) if strand else oriented
        rid = len(reads)
        reads.append(read)
        # cigar walk: leading soft clip offsets the oriented frame; M/I/D
        # consume as usual; H contributes nothing
        qi = 0
        core = []
        ref_span = 0
        q_used = 0
        lead_clip = None
        for length, op in rec.cigar:
            if op in ("S",):
                if lead_clip is None:
                    lead_clip = length
                qi += length
            elif op in ("M", "=", "X"):
                core.append((length, "M"))
                ref_span += length
                q_used += length
            elif op == "I":
                core.append((length, "I"))
                q_used += length
            elif op == "D" or op == "N":
                core.append((length, "D"))
                ref_span += length
        lead_clip = lead_clip or 0
        row = np.zeros(1, ALIGN_DTYPE)[0]
        row["read_id"] = rid
        row["read_length"] = len(read)
        row["read_from"] = lead_clip if strand == 0 \
            else len(read) - (lead_clip + q_used)
        row["read_to"] = row["read_from"] + q_used
        row["strand"] = strand
        row["sequence_id"] = sid
        row["sequence_from"] = rec.pos
        row["sequence_to"] = rec.pos + ref_span
        row["mapq"] = rec.mapq
        rows.append(row)
        cigar_map[(rid, sid)] = (core, lead_clip, strand)
    return reads, rows, cigar_map


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.db and not args.reference:
        print("error: one of --db / --reference is required",
              file=sys.stderr)
        return 2

    from megapath_nano_tpu_torch.align.pipeline import require_device
    from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE, AlignList
    from megapath_nano_tpu_torch.amr.db import AMRGeneDB
    from megapath_nano_tpu_torch.amr.module import run_amr

    require_device(args.device, "mpn-torch-amr --device")
    if args.db:
        from megapath_nano_tpu_torch.db.refdb import RefDB

        db = RefDB.load(args.db)
        idx = db.index
        seq_names = list(idx.seq_names)
        seqs = {i: idx.seq_data[idx.seq_offsets[i]: idx.seq_offsets[i + 1]]
                for i in range(len(seq_names))}
        asm_names = list(db.assembly_names)
    else:
        from megapath_nano_tpu_torch.io.fastq import read_fasta

        names, datas = read_fasta(args.reference)
        seq_names = list(names)
        seqs = dict(enumerate(datas))
        asm_names = list(names)

    name_to_id = {n: i for i, n in enumerate(seq_names)}
    reads, rows, cigar_map = alignments_from_sam(args.query, name_to_id)
    if not rows:
        print("no usable primary alignments in input", file=sys.stderr)
        return 1
    data = np.array(rows, ALIGN_DTYPE)
    best = AlignList(data, seq_names, asm_names,
                     [f"r{i}" for i in range(len(reads))], cigar_map)

    dbs = []
    for d in args.amr_db:
        dbs.append(AMRGeneDB.load(d) if os.path.isdir(d)
                   else AMRGeneDB.from_fasta(
                       os.path.splitext(os.path.basename(d))[0], d))
    protein_db = None
    if args.amr_protein_db:
        import json

        from megapath_nano_tpu_torch.amr.protein import ProteinDB

        with open(os.path.join(args.amr_protein_db, "proteins.json")) as f:
            protein_db = ProteinDB.from_records("cbmar", json.load(f))

    res = run_amr(best, reads, seqs, dbs, min_depth=args.min_depth,
                  device=args.device, organism=args.amr_organism,
                  protein_db=protein_db)
    os.makedirs(args.output_folder, exist_ok=True)
    out = res.write(args.output_folder, args.output_prefix)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

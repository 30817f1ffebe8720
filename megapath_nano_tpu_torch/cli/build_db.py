"""mpn-torch-build-db: build reference / AMR databases from FASTA + metadata.

The framework's db_preparation equivalent (reference: db_preparation/
refseq_download.sh, updateAssemblyMetadata.sh, updateDB.sh, prepareAMR_DB.sh
— README.md:86-105). Network fetches are out of scope in this environment;
this builder consumes local FASTA + TSV metadata:

  # reference DB: one or more assembly FASTAs + an assembly metadata TSV
  python -m megapath_nano_tpu_torch.cli.build_db ref \
      --fasta asm1.fna --fasta asm2.fna \
      --metadata assemblies.tsv --out refdb_dir

  metadata TSV columns: assembly_name  tax_id  species_tax_id  genus_tax_id
                        [species_name]
  (one row per --fasta, same order; omit for all-zero taxonomy)

  # AMR DB: gene FASTA + phenotype TSV (gene <tab> drug[;drug...])
  python -m megapath_nano_tpu_torch.cli.build_db amr \
      --name resfinder --fasta genes.fna --phenotypes pheno.tsv --out amrdb

The port's own copy of megapath_nano_tpu/cli/build_db.py. It builds no
aligner, so it takes no device; the directories it writes load in either
package.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_ref(args) -> int:
    import numpy as np

    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.io.fastq import read_fastq

    sequences, seq_names, seq_assembly = [], [], []
    assembly_names = []
    for ai, path in enumerate(args.fasta):
        batch = read_fastq(path)
        name = args.assembly_name[ai] if args.assembly_name else \
            path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        assembly_names.append(name)
        for i in range(batch.num_reads):
            sequences.append(batch.read(i))
            seq_names.append(batch.ids[i])
            seq_assembly.append(ai)

    tax = [(0, 0, 0)] * len(assembly_names)
    tax_names = {}
    if args.taxdump and args.assembly_summary:
        # derive taxonomy like the reference's genAssemblyMetadata.py:
        # species/genus ids + names from nodes.dmp/names.dmp + the NCBI
        # assembly_summary.txt (accession -> taxid)
        from megapath_nano_tpu_torch.db.taxdump import (Taxonomy,
                                                  parse_assembly_summary)

        taxo = Taxonomy.load(args.taxdump)
        summary = {r["accession"]: r
                   for r in parse_assembly_summary(args.assembly_summary)}
        for ai, name in enumerate(assembly_names):
            row = summary.get(name)
            if row is None:
                continue
            tid, sp, gp, _h = taxo.assembly_tax_row(
                row["tax_id"], row["species_tax_id"] or None)
            tax[ai] = (tid, sp, gp)
            tax_names[sp] = taxo.name_of(sp)
    if args.metadata:
        with open(args.metadata) as f:
            rows = [line.rstrip("\n").split("\t") for line in f
                    if line.strip() and not line.startswith("#")]
        for ai, row in enumerate(rows[: len(assembly_names)]):
            if row[0]:
                assembly_names[ai] = row[0]
            tax[ai] = (int(row[1]), int(row[2]), int(row[3]))
            if len(row) > 4:
                tax_names[int(row[2])] = row[4]

    db = RefDB.build(sequences, seq_names, seq_assembly, assembly_names, tax,
                     tax_names, k=args.k, w=args.w)
    db.save(args.out)
    print(f"RefDB: {len(assembly_names)} assemblies, {len(sequences)} "
          f"sequences, {db.index.num_minimizers} minimizers -> {args.out}")
    return 0


def build_amr(args) -> int:
    from megapath_nano_tpu_torch.amr.db import AMRGeneDB

    db = AMRGeneDB.from_fasta(args.name, args.fasta[0])
    if args.phenotypes:
        table = {}
        with open(args.phenotypes) as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                table[parts[0]] = parts[1].split(";") if len(parts) > 1 else []
        db.attach_phenotypes(table)
    db.save(args.out)
    print(f"AMR DB '{args.name}': {len(db.gene_names)} genes -> {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpn-torch-build-db")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("ref")
    pr.add_argument("--fasta", action="append", required=True)
    pr.add_argument("--assembly_name", action="append")
    pr.add_argument("--metadata")
    pr.add_argument("--taxdump",
                    help="NCBI taxdump dir (nodes.dmp, names.dmp); derives "
                         "tax columns like genAssemblyMetadata.py")
    pr.add_argument("--assembly_summary",
                    help="NCBI assembly_summary.txt (with --taxdump); "
                         "assembly names must be accessions")
    pr.add_argument("--out", required=True)
    pr.add_argument("--k", type=int, default=15)
    pr.add_argument("--w", type=int, default=10)
    pr.set_defaults(fn=build_ref)

    pa = sub.add_parser("amr")
    pa.add_argument("--name", required=True)
    pa.add_argument("--fasta", action="append", required=True)
    pa.add_argument("--phenotypes")
    pa.add_argument("--out", required=True)
    pa.set_defaults(fn=build_amr)

    pp = sub.add_parser(
        "plan", help="RefSeq download plan from assembly_summary.txt files "
                     "(refseq_download.py selection; offline manifest)")
    pp.add_argument("--assembly_summary", action="append", required=True,
                    help="division=path (e.g. bacteria=/x/summary.txt)")
    pp.add_argument("--plasmid_files", type=int, default=8)
    pp.add_argument("--out", required=True)
    pp.set_defaults(fn=plan_refseq)

    pt = sub.add_parser(
        "taxonomy_db", help="build an ncbi_taxonomy.db-compatible SQLite "
                            "file from taxdump (+ assembly_summary)")
    pt.add_argument("--taxdump", required=True)
    pt.add_argument("--assembly_summary")
    pt.add_argument("--out", required=True)
    pt.set_defaults(fn=build_taxonomy)

    args = p.parse_args(argv)
    return args.fn(args)


def plan_refseq(args) -> int:
    from megapath_nano_tpu_torch.db.refseq_plan import (plan_downloads,
                                                  plasmid_plan,
                                                  write_manifest)
    from megapath_nano_tpu_torch.db.taxdump import parse_assembly_summary

    specs = {}
    for item in args.assembly_summary:
        division, _, path = item.partition("=")
        if not path:
            division, path = os.path.basename(item) or "division", item
        specs[division] = plan_downloads(parse_assembly_summary(path))
    if args.plasmid_files:
        specs["plasmid"] = plasmid_plan(args.plasmid_files)
    tsv, sh = write_manifest(args.out, specs)
    n = sum(len(v) for v in specs.values())
    print(f"planned {n} downloads -> {tsv}, {sh}")
    return 0


def build_taxonomy(args) -> int:
    from megapath_nano_tpu_torch.db.sqlite_taxonomy import build_taxonomy_db
    from megapath_nano_tpu_torch.db.taxdump import (Taxonomy,
                                              parse_assembly_summary)

    taxo = Taxonomy.load(args.taxdump)
    rows = (parse_assembly_summary(args.assembly_summary)
            if args.assembly_summary else None)
    path = build_taxonomy_db(args.out, taxonomy=taxo, assembly_rows=rows)
    print(f"built {path}: {len(taxo.parent)} nodes, {len(taxo.names)} names")
    return 0


if __name__ == "__main__":
    sys.exit(main())

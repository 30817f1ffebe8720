"""RefSeq download planning — the offline half of db_preparation.

The reference's refseq_download.py walks each division's
assembly_summary.txt, selects assemblies per species, and wget-fetches
`{ftp_path}/{basename}_genomic.fna.gz` per selection, then concatenates
everything into refseq.fna (reference: db_preparation/refseq_download.py:
27-100 getValidAssemble selection; refseq_download.sh:15-26 division fan-out
+ zcat concat). This environment has no network, so the plan/fetch split is
explicit: plan_downloads() reproduces the selection and emits (accession,
url, md5_url) fetch specs plus a shell manifest; ingest after download goes
through cli/build_db.py (FASTA + taxdump → RefDB).

Selection rule per species group (consecutive species_taxid block), exactly
mirroring refseq_download.py:43-58:
  - refseq_category == 'reference genome'      → always selected
  - refseq_category == 'representative genome' → selected only when the
    species also has a reference genome, and the assembly level is not
    Scaffold/Contig
  - refseq_category == 'na'                    → selected only when the
    species has a reference or representative genome, and the level is not
    Scaffold/Contig

The port's own copy of megapath_nano_tpu/db/refseq_plan.py; its fetch.sh
names the original's module, as the original writes it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

DIVISIONS = ("bacteria", "fungi", "protozoa", "viral", "archaea",
             "vertebrate_mammalian")
SUMMARY_URL = ("https://ftp.ncbi.nlm.nih.gov/genomes/refseq/{division}/"
               "assembly_summary.txt")
PLASMID_URL = ("https://ftp.ncbi.nlm.nih.gov/genomes/refseq/plasmid/"
               "plasmid.{n}.1.genomic.fna.gz")


@dataclass
class FetchSpec:
    accession: str
    species_tax_id: int
    url: str
    md5_url: str


def _select_group(group: list[dict]) -> list[dict]:
    has_ref = any(r.get("refseq_category") == "reference genome"
                  for r in group)
    has_rep = any(r.get("refseq_category") == "representative genome"
                  for r in group)
    out = []
    for r in group:
        cat = r.get("refseq_category", "na")
        level = r.get("assembly_level", "")
        if cat == "reference genome":
            out.append(r)
        elif cat == "representative genome":
            if has_ref and level not in ("Scaffold", "Contig"):
                out.append(r)
        elif cat == "na":
            if (has_ref or has_rep) and level not in ("Scaffold", "Contig"):
                out.append(r)
    return out


def select_assemblies(rows: list[dict]) -> list[dict]:
    """Per-species assembly selection (getValidAssemble parity). `rows`
    come from db.taxdump.parse_assembly_summary and must preserve file
    order (species blocks are consecutive in assembly_summary.txt)."""
    selected: list[dict] = []
    group: list[dict] = []
    cur = None
    for r in rows:
        sp = r.get("species_tax_id", 0)
        if cur is not None and sp != cur:
            selected.extend(_select_group(group))
            group = []
        cur = sp
        group.append(r)
    if group:
        selected.extend(_select_group(group))
    return selected


def plan_downloads(rows: list[dict]) -> list[FetchSpec]:
    """FetchSpecs for the selected assemblies of one division's summary."""
    specs = []
    for r in select_assemblies(rows):
        ftp = r.get("ftp_path", "")
        if not ftp or ftp == "na":
            continue
        base = ftp.rstrip("/").rsplit("/", 1)[-1]
        specs.append(FetchSpec(
            accession=r.get("accession", ""),
            species_tax_id=int(r.get("species_tax_id", 0) or 0),
            url=f"{ftp}/{base}_genomic.fna.gz",
            md5_url=f"{ftp}/md5checksums.txt"))
    return specs


def plasmid_plan(n_files: int = 8) -> list[FetchSpec]:
    """The plasmid division ships numbered archive files, not assemblies
    (refseq_download.sh:23 downloads N of them)."""
    return [FetchSpec(f"plasmid.{i}", 0, PLASMID_URL.format(n=i), "")
            for i in range(1, n_files + 1)]


def write_manifest(out_dir: str, specs_by_division: dict[str, list[FetchSpec]]
                   ) -> tuple[str, str]:
    """Write download.tsv + fetch.sh (wget -c per file, zcat concat at the
    end — the refseq_download.sh workflow as a reproducible manifest)."""
    os.makedirs(out_dir, exist_ok=True)
    tsv = os.path.join(out_dir, "download.tsv")
    sh = os.path.join(out_dir, "fetch.sh")
    with open(tsv, "w") as f:
        f.write("division\taccession\tspecies_tax_id\turl\tmd5_url\n")
        for div, specs in specs_by_division.items():
            for s in specs:
                f.write(f"{div}\t{s.accession}\t{s.species_tax_id}"
                        f"\t{s.url}\t{s.md5_url}\n")
    with open(sh, "w") as f:
        f.write("#!/bin/bash\nset -e\n# generated by megapath_nano_tpu "
                "db.refseq_plan\n")
        for div, specs in specs_by_division.items():
            f.write(f"mkdir -p {div}\n")
            for s in specs:
                f.write(f"wget -c -P {div} {s.url}\n")
        f.write("find . -type f -name '*.gz' -print0 | sort -z | "
                "xargs -0 -I{} sh -c 'zcat {}' >> refseq.fna\n")
    os.chmod(sh, 0o755)
    return tsv, sh

"""AMR consensus report: per-antibiotic merge across databases.

Reproduces merge_results (reference: bin/megapath_nano_amr.py:164-224):
each database contributes per-drug accession ids (':'-joined) and
gene[idscore] labels (';'-joined); drugs are canonicalized
(strip trailing 's' / ' antibiotic', drop dashes, uppercase — :99-107) and
the final table has one row per antibiotic with two columns per database
(<db>_acc_id, <db>_gene[idscore]), written as results.csv (:208-209).

The port's own copy of megapath_nano_tpu/amr/report.py.
"""

from __future__ import annotations

import csv
from collections import defaultdict

from megapath_nano_tpu_torch.amr.db import canonical_drug
from megapath_nano_tpu_torch.amr.scan import AMRHit


def merge_results(hits_by_db: dict[str, list[AMRHit]]) -> dict:
    """-> {antibiotic: {db: {"acc_id": "a:b", "genes": "g1[97.0];g2[...]"}}}
    (the reference's ':'-joined accession and ';'-joined gene[idscore]
    consolidation, megapath_nano_amr.py:149-161)."""
    table: dict[str, dict[str, dict]] = defaultdict(dict)
    for db_name, hits in hits_by_db.items():
        for hit in hits:
            label = f"{hit.gene}[{hit.identity * 100:.2f}]"
            acc = hit.accession or hit.gene
            for drug in hit.drugs or ["UNKNOWN"]:
                canon = canonical_drug(drug)
                if not canon:
                    continue
                cell = table[canon].setdefault(
                    db_name, {"acc": [], "genes": []})
                if acc not in cell["acc"]:
                    cell["acc"].append(acc)
                if label not in cell["genes"]:
                    cell["genes"].append(label)
    return {
        drug: {db: {"acc_id": ":".join(c["acc"]),
                    "genes": ";".join(c["genes"])}
               for db, c in dbs.items()}
        for drug, dbs in table.items()}


def write_results_csv(path: str, merged: dict,
                      db_names: list[str]) -> None:
    """One row per antibiotic; <db>_acc_id + <db>_gene[idscore] column pair
    per database (reference results.csv, megapath_nano_amr.py:186-209)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        header = ["antibiotic"]
        for db in db_names:
            header += [f"{db}_acc_id", f"{db}_gene[idscore]"]
        writer.writerow(header)
        for drug in sorted(merged):
            row = [drug]
            for db in db_names:
                cell = merged[drug].get(db)
                row += ([cell["acc_id"], cell["genes"]] if cell
                        else ["", ""])
            writer.writerow(row)


def write_hydrolytic_profile(path: str, profiles: list[str]) -> None:
    """cbmar_protein_blasted_hydrolytic_profile.txt (reference
    megapath_nano_amr.py:221-224)."""
    with open(path, "w") as f:
        for p in profiles:
            f.write(f"{p}\n")

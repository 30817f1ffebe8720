"""NCBI taxonomy dump (taxdump) parsing and assembly-taxonomy derivation.

The reference derives every assembly's (tax_id, species_tax_id,
genus_tax_id, genus_height) by parsing nodes.dmp and walking parents
(reference: db_preparation/genAssemblyMetadata.py:10-60 rank table +
parseNodesDmp; the "genus" column is the species node's PARENT, whatever its
rank, with that rank's height recorded — genAssemblyMetadata.py:99-105).
Species names come from names.dmp scientific names
(db_preparation/parseDml.py, loaded into the SQLite `names` table by
updateDB.sh). This module reproduces those derivations from local taxdump
files so `build_db ref --taxdump` needs no hand-written metadata TSV.

The port's own copy of megapath_nano_tpu/db/taxdump.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# NCBI rank ladder heights (genAssemblyMetadata.py:10-55; genus = 11,
# species = 4; 'clade' is treated as 'no rank')
RANK_HEIGHT = {
    "no rank": 35, "domain": 34, "superkingdom": 33, "kingdom": 32,
    "subkingdom": 31, "superphylum": 30, "phylum": 29, "subphylum": 28,
    "superclass": 27, "class": 26, "subclass": 25, "infraclass": 24,
    "cohort": 23, "subcohort": 22, "superorder": 21, "order": 20,
    "parvorder": 19, "suborder": 18, "infraorder": 17, "superfamily": 16,
    "family": 15, "subfamily": 14, "tribe": 13, "subtribe": 12,
    "genus": 11, "subgenus": 10, "section": 9, "subsection": 8,
    "series": 7, "species group": 6, "species subgroup": 5, "species": 4,
    "subspecies": 3, "varietas": 2, "forma": 1,
}
GENUS_HEIGHT = RANK_HEIGHT["genus"]
SPECIES_HEIGHT = RANK_HEIGHT["species"]


def _height(rank: str) -> int:
    if rank == "clade":        # excludeClade (genAssemblyMetadata.py:62-66)
        rank = "no rank"
    return RANK_HEIGHT.get(rank, RANK_HEIGHT["no rank"])


@dataclass
class Taxonomy:
    """Parsed taxdump: parent/rank per node plus scientific names."""

    parent: dict[int, int]
    rank: dict[int, str]
    names: dict[int, str]

    @staticmethod
    def load(taxdump_dir: str) -> "Taxonomy":
        nodes = os.path.join(taxdump_dir, "nodes.dmp")
        names = os.path.join(taxdump_dir, "names.dmp")
        parent: dict[int, int] = {}
        rank: dict[int, str] = {}
        with open(nodes) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 3:
                    continue
                tid = int(parts[0])
                parent[tid] = int(parts[1])
                rank[tid] = parts[2]
        name_map: dict[int, str] = {}
        if os.path.exists(names):
            with open(names) as f:
                for line in f:
                    parts = [p.strip() for p in line.split("|")]
                    if len(parts) >= 4 and parts[3] == "scientific name":
                        name_map[int(parts[0])] = parts[1]
        return Taxonomy(parent, rank, name_map)

    def height(self, tax_id: int) -> int:
        return _height(self.rank.get(tax_id, "no rank"))

    def species_of(self, tax_id: int) -> int:
        """Nearest ancestor (or self) of rank species; 0 if none."""
        cur = tax_id
        for _ in range(200):
            if self.rank.get(cur, "") == "species":
                return cur
            nxt = self.parent.get(cur, cur)
            if nxt == cur:
                return 0
            cur = nxt
        return 0

    def assembly_tax_row(self, tax_id: int,
                         species_tax_id: int | None = None):
        """(tax_id, species_tax_id, genus_tax_id, genus_height) — the
        reference's assembly_tax_id row: genus column = parent of the
        species node, with that parent's rank height recorded
        (genAssemblyMetadata.py:99-105)."""
        sp = species_tax_id or self.species_of(tax_id) or tax_id
        gp = self.parent.get(sp, 0)
        return tax_id, sp, gp, self.height(gp) if gp else 0

    def name_of(self, tax_id: int) -> str:
        return self.names.get(tax_id, f"taxid:{tax_id}")


def parse_assembly_summary(path: str) -> list[dict]:
    """NCBI assembly_summary.txt rows (accession, taxid, species_taxid,
    organism_name) — genAssemblyMetadata.py:72-84 reads the same columns."""
    rows = []
    header = None
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                cand = line.lstrip("# ").rstrip("\n").split("\t")
                if "assembly_accession" in cand[0]:
                    header = cand
                continue
            parts = line.rstrip("\n").split("\t")
            if header is None or len(parts) < 3:
                continue
            row = dict(zip(header, parts))
            rows.append({
                "accession": row.get("assembly_accession", parts[0]),
                "tax_id": int(row.get("taxid", 0) or 0),
                "species_tax_id": int(row.get("species_taxid", 0) or 0),
                "organism_name": row.get("organism_name", ""),
                # selection/download columns (refseq_download.py:61 reads
                # refseq_category, assembly_level; :92-96 builds the fetch
                # URL from ftp_path)
                "refseq_category": row.get("refseq_category", "na"),
                "assembly_level": row.get("assembly_level", ""),
                "ftp_path": row.get("ftp_path", ""),
            })
    return rows

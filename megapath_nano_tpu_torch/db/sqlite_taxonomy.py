"""SQLite taxonomy database — schema-compatible with the reference's
`db/ncbi_taxonomy.db`.

The reference builds a 6-table SQLite database (assembly_summary,
sequence_name, ranks, names, nodes, source — reference:
db_preparation/updateDB.sh heredoc CREATE TABLE statements) and queries it
at report time with IN-lists chunked by SQLite's 999-variable limit
(reference: bin/megapath_nano.py:783-799 read_db, :802 get_assembly_info,
:873 get_tax_name, :897 get_sequence_name). This module provides both
directions:

  - build_taxonomy_db(): create a database with the same tables from a
    parsed taxdump + assembly summary + sequence names, so downstream
    consumers of the reference's DB format can read ours;
  - TaxonomyDB: chunked-IN query helpers over any database with this
    schema — including one built by the reference itself (interop path).

The pipeline itself does NOT need SQLite (RefDB keeps name tables as
in-memory dicts); this is the compatibility surface.

The port's own copy of megapath_nano_tpu/db/sqlite_taxonomy.py.
"""

from __future__ import annotations

import os
import sqlite3
from dataclasses import dataclass

# the reference hard-codes SQLITE_MAX_VARIABLE_NUMBER = 999
# (bin/megapath_nano.py:789)
_SQLITE_MAX_VARS = 999

_SCHEMA = """
CREATE TABLE IF NOT EXISTS assembly_summary(
  assembly_id char(20) not null,
  bioproject char(20), biosample char(20), wgs_master char(20),
  refseq_category char(30),
  taxid int not null, species_taxid int not null,
  organism_name char(150), infraspecific_name char(150), isolate char(150),
  version_status char(15), assembly_level char(20), release_type char(15),
  genome_rep char(15), seq_rel_date char(10), asm_name char(150),
  submitter char(255), gbrs_paired_asm char(20), paired_asm_comp char(20),
  ftp_path char(250), excluded_from_refseq char(100),
  relation_to_type_material char(100));
CREATE TABLE IF NOT EXISTS sequence_name (
  sequence_id char(20), sequence_name char(100));
CREATE UNIQUE INDEX IF NOT EXISTS idx_sequence_name_sequence_id
  on sequence_name (sequence_id);
CREATE TABLE IF NOT EXISTS ranks (
  rank VARCHAR NOT NULL, height INTEGER NOT NULL,
  PRIMARY KEY (rank), UNIQUE (height));
CREATE TABLE IF NOT EXISTS names(
  tax_id, tax_name, unique_name, name_class, source_id, is_primary,
  is_classified);
CREATE TABLE IF NOT EXISTS nodes (
  tax_id VARCHAR NOT NULL, parent_id VARCHAR, rank VARCHAR,
  embl_code VARCHAR, division_id VARCHAR, source_id INTEGER,
  is_valid BOOLEAN, PRIMARY KEY (tax_id));
CREATE TABLE IF NOT EXISTS source (
  id INTEGER NOT NULL, name VARCHAR, description VARCHAR,
  PRIMARY KEY (id), UNIQUE (name));
"""


def build_taxonomy_db(path: str, *, taxonomy=None, assembly_rows=None,
                      sequence_names=None) -> str:
    """Create an ncbi_taxonomy.db-compatible SQLite file.

    taxonomy: db.taxdump.Taxonomy (nodes/names/ranks tables)
    assembly_rows: iterable of dicts with at least accession/tax_id/
        species_tax_id/organism_name (parse_assembly_summary output rows;
        extra NCBI columns are carried through when present)
    sequence_names: dict sequence_id -> description line
    """
    if os.path.exists(path):
        os.remove(path)
    conn = sqlite3.connect(path)
    conn.executescript(_SCHEMA)
    if taxonomy is not None:
        from megapath_nano_tpu_torch.db.taxdump import RANK_HEIGHT

        conn.executemany(
            "INSERT INTO ranks VALUES (?, ?)",
            sorted(RANK_HEIGHT.items(), key=lambda kv: kv[1]))
        conn.executemany(
            "INSERT INTO nodes VALUES (?, ?, ?, '', '', 1, 1)",
            ((str(t), str(p), taxonomy.rank.get(t, "no rank"))
             for t, p in taxonomy.parent.items()))
        conn.executemany(
            "INSERT INTO names VALUES (?, ?, '', 'scientific name', 1, 1, 1)",
            ((str(t), n) for t, n in taxonomy.names.items()))
        conn.execute("INSERT INTO source VALUES (1, 'taxdump', "
                     "'NCBI taxdump import')")
    for row in (assembly_rows or []):
        conn.execute(
            "INSERT INTO assembly_summary (assembly_id, taxid, species_taxid,"
            " organism_name, assembly_level, ftp_path) VALUES (?,?,?,?,?,?)",
            (row.get("accession", ""), int(row.get("tax_id", 0)),
             int(row.get("species_tax_id", 0) or 0),
             row.get("organism_name", ""),
             row.get("assembly_level", ""), row.get("ftp_path", "")))
    if sequence_names:
        conn.executemany(
            "INSERT OR REPLACE INTO sequence_name VALUES (?, ?)",
            sequence_names.items())
    conn.commit()
    conn.close()
    return path


@dataclass
class TaxonomyDB:
    """Chunked-IN query helpers over an ncbi_taxonomy.db-schema database.

    Works against databases built by build_taxonomy_db() OR by the
    reference's updateDB.sh — the query shapes replicate
    bin/megapath_nano.py:802/:873/:897."""

    conn: sqlite3.Connection

    @staticmethod
    def open(path: str) -> "TaxonomyDB":
        return TaxonomyDB(sqlite3.connect(path))

    def close(self) -> None:
        self.conn.close()

    def _chunked(self, sql_tmpl: str, keys: list):
        rows = []
        keys = list(keys)
        for i in range(0, len(keys), _SQLITE_MAX_VARS):
            chunk = keys[i: i + _SQLITE_MAX_VARS]
            sql = sql_tmpl.format(key=",".join("?" * len(chunk)))
            rows.extend(self.conn.execute(sql, chunk).fetchall())
        return rows

    def get_tax_names(self, tax_ids) -> dict[int, str]:
        """tax_id -> primary scientific name (get_tax_name parity)."""
        rows = self._chunked(
            "SELECT tax_id, tax_name FROM names WHERE tax_id in ({key})"
            " and is_primary = 1", [str(t) for t in tax_ids])
        return {int(t): n for t, n in rows}

    def get_sequence_names(self, sequence_ids) -> dict[str, str]:
        rows = self._chunked(
            "SELECT sequence_id, sequence_name FROM sequence_name"
            " WHERE sequence_id in ({key})", list(sequence_ids))
        return dict(rows)

    def get_assembly_info(self, assembly_ids) -> list[dict]:
        """Rows of (assembly_id, taxid, species_taxid, organism_name) —
        the columns the reference's step_format_output consumes."""
        rows = self._chunked(
            "SELECT assembly_id, taxid, species_taxid, organism_name"
            " FROM assembly_summary WHERE assembly_id in ({key})",
            list(assembly_ids))
        return [dict(zip(("assembly_id", "tax_id", "species_tax_id",
                          "organism_name"), r)) for r in rows]

    def species_lineage(self, tax_id: int, max_hops: int = 200) -> list[int]:
        """Walk nodes.parent_id to the root (ancestry list incl. self)."""
        out = [int(tax_id)]
        cur = str(tax_id)
        for _ in range(max_hops):
            row = self.conn.execute(
                "SELECT parent_id FROM nodes WHERE tax_id = ?",
                (cur,)).fetchone()
            if row is None or row[0] in (cur, None, ""):
                break
            cur = row[0]
            out.append(int(cur))
        return out

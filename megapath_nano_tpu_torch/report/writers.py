"""Report writers: .preport, .microbe_stat, read stats.

Output surface mirroring step_format_output (reference:
bin/megapath_nano.py:3275-3888): the species-level profile (.preport), the
per-assembly main table (.microbe_stat), and per-read tables. TSV formats
keep the reference's column names so downstream consumers can switch over.

The port's own copy of megapath_nano_tpu/report/writers.py.
"""

from __future__ import annotations

import numpy as np

MICROBE_STAT_COLS = [
    "assembly_id", "tax_id", "species_tax_id", "genus_tax_id",
    "total_number_of_read", "total_read_bp", "total_aligned_bp",
    "average_read_length", "assembly_length", "average_depth",
    "covered_bp", "covered_percent", "noise_span_bp", "noise_span_percent",
    "adjusted_covered_percent", "adjusted_average_depth",
    "adjusted_total_aligned_bp", "average_identity", "average_edit_dist",
    "average_alignment_score",
]


def species_abundance(stat: np.ndarray) -> list[tuple[int, int]]:
    """Aggregate adjusted_total_aligned_bp per species_tax_id, descending —
    the .preport content (megapath_nano.py:3655)."""
    agg: dict[int, int] = {}
    for row in stat:
        sp = int(row["species_tax_id"])
        agg[sp] = agg.get(sp, 0) + int(row["adjusted_total_aligned_bp"])
    return sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))


def write_preport(path: str, stat: np.ndarray,
                  tax_names: dict[int, str] | None = None) -> None:
    tax_names = tax_names or {}
    with open(path, "w") as f:
        f.write("species_tax_id\tname\tadjusted_abundance\n")
        for sp, ab in species_abundance(stat):
            f.write(f"{sp}\t{tax_names.get(sp, str(sp))}\t{ab}\n")


PRE_NOISE_COLS = [
    # pre-noise column block of the main table (reference
    # align_stat_pre_noise_col_name, megapath_nano.py:62-67)
    ("pre_total_number_of_read", "total_number_of_read"),
    ("pre_total_read_bp", "total_read_bp"),
    ("pre_average_read_length", "average_read_length"),
    ("pre_total_aligned_bp", "total_aligned_bp"),
    ("pre_average_depth", "average_depth"),
    ("pre_covered_percent", "covered_percent"),
    ("pre_average_identity", "average_identity"),
    ("pre_average_edit_dist", "average_edit_dist"),
    ("pre_average_alignment_score", "average_alignment_score"),
]


def write_microbe_stat(path: str, stat: np.ndarray,
                       assembly_names: list[str],
                       pre_stat: dict | None = None,
                       similar_marks: dict | None = None) -> None:
    """Main per-assembly table. With pre_stat (assembly_id -> pre-noise stat
    row) the pre_* column block is appended; with similar_marks the
    similar-species marker column is appended (reference
    align_stat_col_name_with_pre_noise_with_similar_species_marker)."""
    cols = list(MICROBE_STAT_COLS)
    if pre_stat is not None:
        cols += [c for c, _src in PRE_NOISE_COLS]
    if similar_marks is not None:
        cols += ["is_similar"]
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        order = np.argsort(-stat["adjusted_total_aligned_bp"], kind="stable")
        for row in stat[order]:
            vals = []
            for col in MICROBE_STAT_COLS:
                v = row[col]
                if col == "assembly_id":
                    vals.append(assembly_names[int(v)]
                                if int(v) < len(assembly_names) else str(int(v)))
                elif isinstance(v, np.floating):
                    vals.append(f"{float(v):.6f}")
                else:
                    vals.append(str(int(v)))
            if pre_stat is not None:
                pre = pre_stat.get(int(row["assembly_id"]))
                for _c, src_col in PRE_NOISE_COLS:
                    if pre is None:
                        vals.append("0")
                    else:
                        v = pre[src_col]
                        vals.append(f"{float(v):.6f}"
                                    if isinstance(v, np.floating)
                                    else str(int(v)))
            if similar_marks is not None:
                vals.append(str(int(bool(
                    similar_marks.get(int(row["assembly_id"]), False)))))
            f.write("\t".join(vals) + "\n")


def write_stat_table(path: str, stat: np.ndarray,
                     names: list[str]) -> None:
    """Generic stat-table writer (.id_stat/.raw_stat/.unique_stat/
    .human_stat/.decoy_stat/.microbe_stat_by_sequence_id — reference
    align_stat_raw_col_name tables, megapath_nano.py:68-76)."""
    write_microbe_stat(path, stat, names)


def write_align_list_tsv(path: str, align_list) -> None:
    """align_list rows in the reference's 18-column schema
    (megapath_nano.py:110-115), names resolved from the list's tables."""
    cols = ["read_id", "read_length", "read_from", "read_to", "strand",
            "sequence_id", "sequence_length", "sequence_from", "sequence_to",
            "match", "mapq", "edit_dist", "alignment_score", "assembly_id",
            "tax_id", "species_tax_id", "genus_tax_id",
            "alignment_score_tiebreaker"]
    seq_names = align_list.sequence_names
    asm_names = align_list.assembly_names
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        d = align_list.data
        order = np.argsort(d["read_id"], kind="stable")
        for row in d[order]:
            vals = []
            for c in cols:
                v = row[c]
                if c == "strand":
                    vals.append("-" if int(v) else "+")
                elif c == "sequence_id":
                    vals.append(seq_names[int(v)]
                                if int(v) < len(seq_names) else str(int(v)))
                elif c == "assembly_id":
                    vals.append(asm_names[int(v)]
                                if int(v) < len(asm_names) else str(int(v)))
                elif c == "alignment_score_tiebreaker":
                    vals.append(f"{float(v):.9f}")
                else:
                    vals.append(str(int(v)))
            f.write("\t".join(vals) + "\n")


def write_bed_tsv(path: str, bed: np.ndarray, seq_names: list[str],
                  asm_names: list[str]) -> None:
    """Noise bed as (sequence_id, start, end, assembly_id) rows — the
    reference's bed column convention (megapath_nano.py:18)."""
    with open(path, "w") as f:
        for row in bed:
            sid = int(row["sequence_id"])
            aid = int(row["assembly_id"])
            sn = seq_names[sid] if sid < len(seq_names) else str(sid)
            an = asm_names[aid] if aid < len(asm_names) else str(aid)
            f.write(f"{sn}\t{int(row['start'])}\t{int(row['end'])}"
                    f"\t{an}\n")


def write_genome_set(path: str, assembly_names: list[str], stat: np.ndarray,
                     db) -> None:
    """Aligned-assembly table (.genome_set, megapath_nano.py:3335)."""
    with open(path, "w") as f:
        f.write("assembly_id\tassembly_length\ttax_id\tspecies_tax_id"
                "\tgenus_tax_id\n")
        for row in stat:
            aid = int(row["assembly_id"])
            name = assembly_names[aid] if aid < len(assembly_names) \
                else str(aid)
            f.write(f"{name}\t{int(row['assembly_length'])}"
                    f"\t{int(row['tax_id'])}\t{int(row['species_tax_id'])}"
                    f"\t{int(row['genus_tax_id'])}\n")


def write_read_stat(path: str, categories: dict[str, dict]) -> None:
    """Totals per category (read_stat, megapath_nano.py:3235-3269):
    categories maps name -> {'reads': n, 'bp': n}."""
    with open(path, "w") as f:
        f.write("category\tnumber_of_read\ttotal_read_bp\n")
        for name, d in categories.items():
            f.write(f"{name}\t{d['reads']}\t{d['bp']}\n")

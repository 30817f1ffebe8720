"""Reference judgement of a profile run's placement and `.preport`.

Each read the profile received (a trimmed part of an input read) comes
from one species, known from the generator. Two numbers:

- `misplaced_pct`: the share of those reads whose best alignment (the
  `.bam_filter` table) is missing or names another species;
- `abundance_gap_pp`: the largest gap, in percentage points, between a
  species' share of the `.preport` abundance and its true share, over
  every species either side names. The configuration's abundance is
  MegaPath-Nano's adjusted one: a species' aligned bases times the share
  of its genome they cover. The true one takes both from the generator:
  the genome intervals of the inserts of every read that reached the
  profile.
"""

from __future__ import annotations

import numpy as np


def read_table(path: str) -> tuple[list[str], list[list[str]]]:
    with open(path) as f:
        lines = [l.rstrip("\n").split("\t") for l in f if l.strip()]
    return (lines[0], lines[1:]) if lines else ([], [])


def best_species(path: str, n_reads: int) -> np.ndarray:
    """species_tax_id of each profiled read's row in `.bam_filter`, -1
    where it has none."""
    out = np.full(n_reads, -1, np.int64)
    head, rows = read_table(path)
    if not rows:
        return out
    ri, si = head.index("read_id"), head.index("species_tax_id")
    for r in rows:
        out[int(r[ri])] = int(r[si])
    return out


def preport(path: str) -> dict[int, float]:
    head, rows = read_table(path)
    if not rows:
        return {}
    si, ai = head.index("species_tax_id"), head.index("adjusted_abundance")
    return {int(r[si]): float(r[ai]) for r in rows}


def misplaced(best: np.ndarray, truth: np.ndarray) -> np.ndarray:
    return best != truth


def covered(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, -1
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def true_abundance(genome: np.ndarray, inserts: list, species: np.ndarray,
                   genome_len: np.ndarray) -> dict[int, float]:
    """Adjusted abundance a species' reads should give: per genome, the
    inserts' bases times the share of the genome they cover, summed by
    species."""
    by_genome: dict[int, list] = {}
    for g, ivs in zip(genome.tolist(), inserts):
        by_genome.setdefault(g, []).extend(ivs)
    out: dict[int, float] = {}
    for g, ivs in by_genome.items():
        aligned = sum(b - a for a, b in ivs)
        ab = aligned * covered(ivs) / float(genome_len[g])
        sp = int(species[g])
        out[sp] = out.get(sp, 0.0) + ab
    return out


def abundance_gap(reported: dict[int, float], true: dict[int, float]
                  ) -> float:
    t_sum = sum(true.values()) or 1.0
    r_sum = sum(reported.values()) or 1.0
    gap = 0.0
    for sp in set(true) | set(reported):
        gap = max(gap, abs(100.0 * reported.get(sp, 0.0) / r_sum
                           - 100.0 * true.get(sp, 0.0) / t_sum))
    return gap

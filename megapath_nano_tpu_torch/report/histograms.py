"""Per-category read quality / length histograms.

The reference archives per-category quality-score and read-length
distributions (.quality_score.tar.gz / .read_length.tar.gz, reference:
bin/megapath_nano.py:3235-3269 step_read_statistics and the outputs listed
at :3275-3888). Same content here as plain TSVs per category.

The port's own copy of megapath_nano_tpu/report/histograms.py.
"""

from __future__ import annotations

import os

import numpy as np

QUALITY_BINS = np.arange(0, 61, 1)        # phred 0..60
LENGTH_BINS = np.array(
    [0, 200, 500, 1000, 2000, 5000, 10000, 20000, 50000, 100000, 10 ** 9])


def histogram_table(values: np.ndarray, bins: np.ndarray) -> list[tuple]:
    counts, edges = np.histogram(values, bins=bins)
    return [(float(edges[i]), float(edges[i + 1]), int(c))
            for i, c in enumerate(counts)]


def write_histograms(
    out_dir: str,
    prefix: str,
    categories: dict[str, dict[str, np.ndarray]],
    *,
    length_bin: int | None = None,
    quality_bin: float | None = None,
) -> dict[str, str]:
    """categories: name -> {'lengths': arr, 'quals': arr} (either optional).

    Writes <prefix>.read_length / <prefix>.quality_score with one section
    per category. length_bin / quality_bin switch to fixed-width bins
    (the reference's --read_length_bin_size, default 100 /
    --quality_score_bin_size, default 0.2: megapath_nano.py:5131-5132);
    None keeps the default log-ish length edges / 1-phred quality bins."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    lbins = LENGTH_BINS if length_bin is None else np.arange(
        0, 100_001, max(int(length_bin), 1))
    qbins = QUALITY_BINS if quality_bin is None else np.arange(
        0.0, 60.0 + quality_bin, max(float(quality_bin), 1e-3))
    lp = os.path.join(out_dir, f"{prefix}.read_length")
    qp = os.path.join(out_dir, f"{prefix}.quality_score")
    with open(lp, "w") as f:
        f.write("category\tbin_lo\tbin_hi\tcount\n")
        for name, d in categories.items():
            if "lengths" in d and d["lengths"] is not None:
                for lo, hi, c in histogram_table(d["lengths"], lbins):
                    f.write(f"{name}\t{lo:.0f}\t{hi:.0f}\t{c}\n")
    with open(qp, "w") as f:
        f.write("category\tbin_lo\tbin_hi\tcount\n")
        for name, d in categories.items():
            if "quals" in d and d["quals"] is not None:
                for lo, hi, c in histogram_table(d["quals"], qbins):
                    f.write(f"{name}\t{lo:.1f}\t{hi:.1f}\t{c}\n")
    paths["read_length"] = lp
    paths["quality_score"] = qp
    return paths

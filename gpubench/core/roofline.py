"""Least times of the extension and chain kernels on one H100 (frozen).

A copy of `chip_smoke.py`'s bound arithmetic. The least time of a call is
the larger of its bytes over the HBM rate and its integer operations over
the integer pipe's rate; a kernel's roofline share is that least time over
its measured time.

Assumed peaks, for one NVIDIA H100 SXM at its full 700 W power limit (a
card set lower runs slower under load; the harness reports the limit
beside each share):
- HBM: 3.35e12 bytes/s (NVIDIA's data sheet);
- int32 compares, maxima and selects: 16.75e12 op/s = 64 a clock an SM x
  132 SMs x 1.98 GHz (the data sheet's 67e12 float32 FLOP/s over four,
  one op a lane a clock on a quarter of the pipes); a DPX instruction is
  taken at the same rate. Additions are left out: an integer add can go as
  a multiply-add down the floating-point pipe.

Counts are what the inputs need: a banded extension's rows stop at each
pair's own read length, a chain's predecessors at min(i, window).
"""

from __future__ import annotations

import subprocess

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# banded_sw_full, a cell: substitution 1, E 1, Hnod 1, dead cell 1, F 1,
# H 1, running best 1 (the score-only program's 7), and for the companions
# P and B: diagonal 4, E 2, Hnod 2, F 2, H 3, H > 0 2
SW_FULL_OPS_PER_CELL = 22
SW_SCORES_OPS_PER_CELL = 7
SW_FULL_OUT_COLS = 7
SW_SCORES_OUT_COLS = 3
# chain_and_extents, a pair: |dq - dt| 1, range tests 3, alpha 1, the
# masking select 1, maximum with winner flag 1, select of its index 1
CHAIN_OPS_PER_PAIR = 8


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, 'bytes' or 'operations')."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sw_counts(n_pairs: int, q_max: int, t_max: int, read_lens: np.ndarray,
              band: int, out_cols: int = SW_FULL_OUT_COLS,
              ops_per_cell: int = SW_FULL_OPS_PER_CELL) -> tuple[int, int]:
    """(bytes, operations) of one banded extension call: int8 read and ref
    planes and int32 lengths in, out_cols int32 a pair out; cells = sum
    over pairs of min(read length, q_max) x band."""
    n_bytes = n_pairs * (q_max + t_max) + 4 * 2 * n_pairs \
        + 4 * out_cols * n_pairs
    cells = int(np.minimum(np.asarray(read_lens, np.int64), q_max).sum()) \
        * band
    return n_bytes, cells * ops_per_cell


def chain_counts(q_itemsize: int, n_groups: int, a_max: int,
                 counts: np.ndarray, window: int = 32,
                 bandwidth: int = 500) -> tuple[int, int]:
    """(bytes, operations) of one chain call on (N, A) planes of
    q_itemsize bytes and int32 counts: pairs = for every live anchor i of
    a group, its min(i, window) predecessors."""
    n_bytes = 2 * q_itemsize * n_groups * a_max + 4 * n_groups \
        + 4 * (bandwidth + 1) + 24 * n_groups
    c = np.clip(np.asarray(counts, np.int64), 0, a_max)
    w = np.minimum(c, window)
    pairs = int((w * (w - 1) // 2 + (c - w) * window).sum())
    return n_bytes, pairs * CHAIN_OPS_PER_PAIR


def power_limit_w() -> str:
    """The card's power limit as nvidia-smi reports it, or 'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"

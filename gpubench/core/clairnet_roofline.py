"""Least time of the variant model's forward passes on one H100.

ClairNet's forward (`reference.clairnet`) at the configuration's widths:
per row of 33 positions, the slice dense layer (32 -> slice), a
bidirectional LSTM of `hidden` units (per step and direction the input and
recurrent products into four gates), dense layers of 256 and 128 on the
centre and pooled outputs (4 hidden), and the four heads (21 + 3 + 5 + 5).
Operations count each multiply-add of those matrix products as 2 and each
bias add as 1; the gates' and activations' pointwise work is left out, so
the least time is if anything too low. Bytes: per model call its weights
read once and its rows' float32 inputs read and head outputs written once.

Assumed peaks, one NVIDIA H100 SXM at its full 700 W power limit (a card
set lower runs slower; traced runs report the limit beside the share):
- float32 outside the tensor cores: 66.9e12 FLOP/s (NVIDIA's data sheet's
  67 TFLOP/s; the port runs the model in float32 without TF32);
- HBM: 3.35e12 bytes/s.

The share `clairnet_roofline_pct.amplicon` is the least time of the real
rows (the candidates each model scored, not the padding of its batches)
over the device time of the kernels launched inside the harness range
`gpubench.clairnet` around every model call.
"""

from __future__ import annotations

FP32_FLOPS_PER_S = 66.9e12
HBM_BYTES_PER_S = 3.35e12
POSITIONS = 33
INPUTS = 32                      # 8 rows x 4 channels a position
DENSE = (256, 128)
HEADS = (21, 3, 5, 5)


def widths(variant: dict) -> dict:
    return {"hidden": int(variant["hidden"]), "slice": int(variant["slice"])}


def flops_per_row(hidden: int, slice: int) -> int:
    gates = 4 * hidden
    ops = POSITIONS * (2 * INPUTS * slice + slice)
    ops += 2 * POSITIONS * (2 * (slice + hidden) * gates + gates)
    width = 4 * hidden
    for out in DENSE + HEADS:
        ops += 2 * width * out + out
        if out in DENSE:
            width = out
        else:
            width = DENSE[-1]
    return ops


def weight_bytes(hidden: int, slice: int) -> int:
    gates = 4 * hidden
    n = INPUTS * slice + slice + 2 * ((slice + hidden) * gates + gates)
    width = 4 * hidden
    for out in DENSE:
        n += width * out + out
        width = out
    n += sum(width * out + out for out in HEADS)
    return 4 * n


def least_s(rows: int, calls: int, w: dict) -> tuple[float, str]:
    """(least seconds, 'operations' or 'bytes') of `calls` model calls
    scoring `rows` rows in all."""
    t_ops = rows * flops_per_row(w["hidden"], w["slice"]) / FP32_FLOPS_PER_S
    n_bytes = calls * weight_bytes(w["hidden"], w["slice"]) \
        + rows * 4 * (POSITIONS * INPUTS + sum(HEADS))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

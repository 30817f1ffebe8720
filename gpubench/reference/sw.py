"""Plain PyTorch local alignment with affine gaps: the benchmark's reference.

Smith-Waterman over a batch of (query, target) pairs, unbanded, in int32.
A gap of length L costs gap_open + (L - 1) * gap_extend. Substitution:
+match on equal codes, -mismatch otherwise; with `n_zero`, code 4 (N)
scores 0 against anything. Padding (code -1) never aligns.

The DP runs one query row at a time over the whole target row: F (the gap
along the query) is elementwise from the previous row; E (the gap along the
target) is a running maximum along the row, taken over the row before E is
added, which is exact because gap_open >= gap_extend. Written from the
recurrence alone; it shares no code with the program it judges.
"""

from __future__ import annotations

import numpy as np
import torch

PAD = -1
NEG = -(2 ** 28)


def pad_batch(seqs: list[np.ndarray], device, width: int | None = None
              ) -> torch.Tensor:
    width = width or max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max(width, 1)), PAD, np.int8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return torch.as_tensor(out, device=device)


def local_affine(query: torch.Tensor, target: torch.Tensor, *, match: int,
                 mismatch: int, gap_open: int, gap_extend: int,
                 n_zero: bool = False, want_colmax: bool = False):
    """query (B, Lq), target (B, Lt) int8 with PAD after each sequence.
    Returns (best (B,) int32, colmax (B, Lt) int32 or None): colmax[b, j]
    is the highest cell in target column j, so the columns where it equals
    best are the ends of optimal local alignments."""
    if gap_open < gap_extend:
        raise ValueError("gap_open must be >= gap_extend")
    dev = target.device
    b, lt = target.shape
    t = target.to(torch.int32)
    t_pad = t == PAD
    k = torch.arange(lt + 1, device=dev, dtype=torch.int32)[None, :]
    ramp = k * gap_extend
    h = torch.zeros((b, lt + 1), dtype=torch.int32, device=dev)
    f = torch.full((b, lt + 1), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(b, dtype=torch.int32, device=dev)
    colmax = torch.zeros((b, lt), dtype=torch.int32, device=dev) \
        if want_colmax else None
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    for i in range(query.shape[1]):
        q = query[:, i].to(torch.int32)[:, None]
        sub = torch.where(t == q, match, -mismatch)
        if n_zero:
            sub = torch.where((t == 4) | (q == 4), 0, sub)
        sub = torch.where(t_pad | (q == PAD), NEG, sub)
        diag = h[:, :-1] + sub
        f = torch.maximum(h - gap_open, f - gap_extend)
        h0 = torch.clamp_min(torch.maximum(
            torch.cat([zero_col, diag], 1), f), 0)
        h0[:, 0] = 0
        run = torch.cummax(h0 + ramp, 1).values
        e = run[:, :-1] - gap_open - ramp[:, :-1]
        h = torch.cat([zero_col, torch.maximum(h0[:, 1:], e)], 1)
        best = torch.maximum(best, h[:, 1:].max(1).values)
        if colmax is not None:
            torch.maximum(colmax, h[:, 1:], out=colmax)
    return best, colmax


def reverse_padded(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first lens[b] entries, keeping PAD after them."""
    b, l = x.shape
    j = torch.arange(l, device=x.device)[None, :]
    src = lens[:, None] - 1 - j
    out = torch.gather(x, 1, src.clamp_min(0))
    return torch.where(src >= 0, out, torch.full_like(x, PAD))

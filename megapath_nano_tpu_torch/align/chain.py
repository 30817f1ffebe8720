"""Anchor chaining DP (minimap2-style), under the module name the TPU
package uses (megapath_nano_tpu.align.chain).

The map path's chain DP with extents (`chain_and_extents`: a CUDA kernel on
the card, its plain version on the CPU) lives in
megapath_nano_tpu_torch.kernels.chain and is re-exported here. The other
functions are plain PyTorch / numpy ports of the reference's helpers that
no map path calls:

  chain_scores            per-anchor scores and parent pointers, (f,
                          parent, best_score, best_idx)
  chain_extents           follow the parents from best_idx on the device
  backtrack_chain         the same walk for one row on the host
  chain_scores_reference  the scalar numpy DP the tests hold both to

Scoring (minimap2's map-ont defaults):
  f[i] = max( max_{j in window} f[j] + alpha(j,i) - beta(j,i),  k )
  alpha = min(dq, dt, k)
  beta  = int(0.01 * k * |dq - dt| + 0.5 * log2(max(|dq - dt|, 1)))
  invalid j (dq <= 0, dt <= 0, dq > max_dist, dt > max_dist,
             |dq - dt| > bandwidth) are masked out.
beta comes from `beta_table` (float32, as the reference computes it), so
the scores are bit-equal to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from megapath_nano_tpu_torch.kernels.chain import (  # noqa: F401
    NEG, beta_table, beta_tensor, chain_and_extents,
    chain_and_extents_torch)

__all__ = ["backtrack_chain", "beta_table", "chain_and_extents",
           "chain_and_extents_torch", "chain_extents", "chain_scores",
           "chain_scores_reference"]


def chain_scores(q_pos, t_pos, n_anchors, *, window: int = 32, k: int = 15,
                 max_dist: int = 5000, bandwidth: int = 500,
                 min_score: int = 0):
    """Returns (f, parent, best_score, best_idx), all int32.

    q_pos, t_pos: (N, A) anchor end positions (sorted by target per row);
    n_anchors: (N,) valid count per row. f: (N, A) chain score per anchor
    (NEG past n_anchors); parent: (N, A) predecessor index (-1 = chain
    start); best_*: the row's optimum (the first anchor that reaches it; a
    score below max(min_score, 1) reads 0)."""
    i32 = torch.int32
    q = torch.as_tensor(q_pos).to(i32)
    t = torch.as_tensor(t_pos).to(i32)
    n, a = q.shape
    dev = q.device
    cnt = torch.as_tensor(n_anchors).to(device=dev, dtype=i32)
    beta = beta_tensor(k, bandwidth, dev)
    valid = torch.arange(a, device=dev)[None, :] < cnt[:, None]
    slot = torch.arange(window, dtype=i32, device=dev)[None, :]

    f_win = torch.full((n, window), NEG, dtype=i32, device=dev)
    q_win = torch.zeros((n, window), dtype=i32, device=dev)
    t_win = torch.zeros((n, window), dtype=i32, device=dev)
    i_win = torch.full((n, window), -1, dtype=i32, device=dev)

    def slide(w, new):
        return torch.cat([w[:, 1:], new[:, None]], dim=1)

    f_cols, p_cols = [], []
    for i in range(a):
        qv, tv = q[:, i], t[:, i]
        dq = qv[:, None] - q_win
        dt = tv[:, None] - t_win
        dd = (dq - dt).abs()
        ok = (dq > 0) & (dt > 0) & (dq <= max_dist) & (dt <= max_dist) \
            & (dd <= bandwidth) & (i_win >= 0)
        alpha = torch.clamp(torch.minimum(dq, dt), max=k)
        cand = torch.where(ok, f_win + alpha - beta[dd.clamp(0, bandwidth)
                                                    .long()], NEG)
        best_prev = cand.amax(dim=1)
        # the first maximum: the oldest anchor wins ties
        best_j = torch.where(cand == best_prev[:, None], slot,
                             window).amin(dim=1).long()
        row_valid = valid[:, i]
        parent_i = torch.where(
            (best_prev >= k) & row_valid,
            torch.gather(i_win, 1, best_j[:, None])[:, 0], -1)
        fi = torch.where(row_valid, torch.clamp(best_prev, min=k), NEG)
        f_win, q_win, t_win = slide(f_win, fi), slide(q_win, qv), \
            slide(t_win, tv)
        i_win = slide(i_win, torch.where(row_valid, i, -1).to(i32))
        f_cols.append(fi)
        p_cols.append(parent_i.to(i32))

    f = torch.stack(f_cols, dim=1)
    parent = torch.stack(p_cols, dim=1)
    f_masked = torch.where(valid, f, NEG)
    best_score = f_masked.amax(dim=1)
    col = torch.arange(a, device=dev)[None, :]
    best_idx = torch.where(f_masked == best_score[:, None], col,
                           a).amin(dim=1).to(i32)
    best_score = torch.where(best_score < max(min_score, 1), 0,
                             best_score).to(i32)
    return f, parent, best_score, best_idx


def chain_extents(q_pos, t_pos, parent, best_idx):
    """Chain backtrack on the device: follow parent pointers from best_idx
    and return (q_min, q_max, t_min, t_max, length) per row, int32, without
    shipping the parent matrix to the host. A row with no chain keeps the
    start values (2**30, -2**30, 2**30, -2**30, 0)."""
    i32 = torch.int32
    q = torch.as_tensor(q_pos).to(i32)
    t = torch.as_tensor(t_pos).to(i32)
    par = torch.as_tensor(parent).to(device=q.device, dtype=i32)
    n, a = q.shape
    big = 2 ** 30
    cur = torch.as_tensor(best_idx).to(device=q.device, dtype=i32)
    qmin = torch.full((n,), big, dtype=i32, device=q.device)
    qmax = torch.full((n,), -big, dtype=i32, device=q.device)
    tmin, tmax = qmin.clone(), qmax.clone()
    cnt = torch.zeros((n,), dtype=i32, device=q.device)
    for _ in range(a):
        live = cur >= 0
        cc = torch.clamp(cur, min=0).long()[:, None]
        qa = torch.gather(q, 1, cc)[:, 0]
        ta = torch.gather(t, 1, cc)[:, 0]
        qmin = torch.where(live, torch.minimum(qmin, qa), qmin)
        qmax = torch.where(live, torch.maximum(qmax, qa), qmax)
        tmin = torch.where(live, torch.minimum(tmin, ta), tmin)
        tmax = torch.where(live, torch.maximum(tmax, ta), tmax)
        cnt = cnt + live.to(i32)
        cur = torch.where(live, torch.gather(par, 1, cc)[:, 0], -1)
    return qmin, qmax, tmin, tmax, cnt


def backtrack_chain(parent_row: np.ndarray, best_idx: int) -> np.ndarray:
    """Host-side chain extraction: follow parents from the best anchor."""
    chain = []
    i = int(best_idx)
    seen = 0
    while i >= 0 and seen <= len(parent_row):
        chain.append(i)
        i = int(parent_row[i])
        seen += 1
    return np.array(chain[::-1], dtype=np.int32)


def chain_scores_reference(q_pos, t_pos, *, window=32, k=15, max_dist=5000,
                           bandwidth=500):
    """Scalar numpy reference of the same DP (for tests)."""
    a = len(q_pos)
    f = np.zeros(a, np.int64)
    parent = np.full(a, -1, np.int64)
    for i in range(a):
        best_prev = None
        bj = -1
        for j in range(max(0, i - window), i):
            dq = q_pos[i] - q_pos[j]
            dt = t_pos[i] - t_pos[j]
            dd = abs(dq - dt)
            if dq <= 0 or dt <= 0 or dq > max_dist or dt > max_dist \
                    or dd > bandwidth:
                continue
            alpha = min(dq, dt, k)
            beta = int(0.01 * k * dd + 0.5 * (np.log2(dd) if dd > 0 else 0))
            cand = f[j] + alpha - beta
            if best_prev is None or cand > best_prev:
                best_prev = cand
                bj = j
        if best_prev is not None and best_prev >= k:
            f[i] = max(best_prev, k)
            parent[i] = bj
        else:
            f[i] = k
            parent[i] = -1
    return f, parent

"""Anchor chaining DP with extents (minimap2-style).

Port of megapath_nano_tpu.align.chain.chain_and_extents, the lax.scan the
TPU package's map path runs (its Pallas twin, kernels/chain.py
_chain_kernel, computes the same). The recurrence becomes the hand-written
CUDA kernel in `csrc/chain.cu`; `chain_and_extents_torch` is its plain
PyTorch version, a loop over anchors that mirrors the scan body.

  f[i] = max(max_{j<i, i-j<=window} f[j] + alpha - beta, k)
  alpha = min(dq, dt, k)
  beta  = int32(float32(0.01 * k) * dd + 0.5 * log2(dd)),  dd = |dq - dt|

A predecessor is masked when dq or dt is <= 0 or > max_dist, or when
dd > bandwidth; the oldest predecessor wins ties. beta is read from an
int32 table over dd in [0, bandwidth], built once on the host with the
reference's float32 arithmetic, so the kernel and the plain version do no
float math at all.

The wrapper dispatches on where the tensors lie: on the CPU it runs the
plain version, on a CUDA device it launches the kernel (or raises). It counts
its kernel launches in `chain_and_extents.launches`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from megapath_nano_tpu_torch.kernels import build

NEG = -(2 ** 28)


@functools.lru_cache(maxsize=8)
def beta_table(k: int, bandwidth: int) -> np.ndarray:
    """int32 gap cost for every dd in [0, bandwidth], computed in float32
    exactly as the reference expression (mul, mul, add; no fused
    multiply-add), truncated toward zero. Read-only."""
    dd = np.arange(bandwidth + 1)
    log_dd = np.where(dd > 0,
                      np.log2(np.maximum(dd, 1).astype(np.float32)),
                      np.float32(0.0)).astype(np.float32)
    beta = (np.float32(0.01 * k) * dd.astype(np.float32)
            + np.float32(0.5) * log_dd)
    table = beta.astype(np.int32)
    table.setflags(write=False)
    return table


def chain_and_extents_torch(q_pos, t_pos, n_anchors, beta, *, window, k,
                            max_dist, bandwidth):
    """Plain PyTorch version on (N, A) int32 anchors, (N,) counts and the
    beta table tensor. Returns (6, N) int32."""
    i32 = torch.int32
    q = q_pos.to(i32)
    t = t_pos.to(i32)
    n, a = q.shape
    dev = q.device
    valid = torch.arange(a, device=dev)[None, :] < n_anchors[:, None]
    slot = torch.arange(window, dtype=i32, device=dev)[None, :]

    def win(fill, dtype=i32):
        return torch.full((n, window), fill, dtype=dtype, device=dev)

    f_win, q_win, t_win = win(NEG), win(0), win(0)
    live = win(False, torch.bool)
    qmin_win, tmin_win, cnt_win = win(0), win(0), win(0)
    f_all, qmin_all, tmin_all, cnt_all = [], [], [], []

    def slide(w, new):
        return torch.cat([w[:, 1:], new[:, None]], dim=1)

    def pick(w, j):
        return torch.gather(w, 1, j[:, None])[:, 0]

    for i in range(a):
        qv, tv = q[:, i], t[:, i]
        dq = qv[:, None] - q_win
        dt = tv[:, None] - t_win
        dd = (dq - dt).abs()
        ok = (dq > 0) & (dt > 0) & (dq <= max_dist) & (dt <= max_dist) \
            & (dd <= bandwidth) & live
        alpha = torch.clamp(torch.minimum(dq, dt), max=k)
        cost = beta[dd.clamp(0, bandwidth).long()]
        cand = torch.where(ok, f_win + alpha - cost, NEG)
        best_prev = cand.amax(dim=1)
        best_j = torch.where(cand == best_prev[:, None], slot,
                             window).amin(dim=1).clamp(max=window - 1).long()
        has = best_prev >= k
        fi = torch.where(valid[:, i], torch.clamp(best_prev, min=k), NEG)
        qmin_i = torch.where(has, pick(qmin_win, best_j), qv)
        tmin_i = torch.where(has, pick(tmin_win, best_j), tv)
        cnt_i = torch.where(has, pick(cnt_win, best_j) + 1, 1)
        f_win, q_win, t_win = slide(f_win, fi), slide(q_win, qv), \
            slide(t_win, tv)
        live = slide(live, valid[:, i])
        qmin_win, tmin_win = slide(qmin_win, qmin_i), slide(tmin_win, tmin_i)
        cnt_win = slide(cnt_win, cnt_i)
        f_all.append(fi)
        qmin_all.append(qmin_i)
        tmin_all.append(tmin_i)
        cnt_all.append(cnt_i)

    f = torch.where(valid, torch.stack(f_all, dim=1), NEG)
    best = f.amax(dim=1)
    col = torch.arange(a, device=dev)[None, :]
    bi = torch.where(f == best[:, None], col, a).amin(dim=1)[:, None]

    def at(x):
        return torch.gather(x, 1, bi)[:, 0]

    return torch.stack([
        torch.clamp(best, min=0), at(torch.stack(qmin_all, dim=1)), at(q),
        at(torch.stack(tmin_all, dim=1)), at(t),
        at(torch.stack(cnt_all, dim=1))]).to(i32)


def _chain_cuda(q, t, cnt, beta, *, window, k, max_dist, bandwidth):
    lib = build.load()
    n, a = q.shape
    out = torch.empty((6, n), dtype=torch.int32, device=q.device)
    device, stream = build.launch_args(q)
    build.check(lib.mpn_chain(
        q.data_ptr(), t.data_ptr(), cnt.data_ptr(), beta.data_ptr(),
        out.data_ptr(), n, a, window, k, max_dist, bandwidth, device,
        stream), "mpn_chain")
    build.count_launch(chain_and_extents)
    return out


def chain_and_extents(q_pos, t_pos, n_anchors, *, window: int = 32,
                      k: int = 15, max_dist: int = 5000,
                      bandwidth: int = 500):
    """Single-pass chaining with extents on (N, A) anchor positions (int16
    or int32, sorted by target position per row) and (N,) anchor counts.
    Returns (6, N) int32 [best, q_min, q_max, t_min, t_max, chain_len],
    bit-equal to the TPU package's chain_and_extents."""
    dev = q_pos.device
    for name, x in (("t_pos", t_pos), ("n_anchors", n_anchors)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q_pos on {dev}")
    if q_pos.dim() != 2 or q_pos.shape != t_pos.shape or q_pos.shape[1] == 0:
        raise ValueError(f"anchor planes must be (N, A>0); got "
                         f"{tuple(q_pos.shape)} and {tuple(t_pos.shape)}")
    if not 1 <= window <= 32:
        raise ValueError(f"window must be in [1, 32]; got {window}")
    q = q_pos.to(torch.int32).contiguous()
    t = t_pos.to(torch.int32).contiguous()
    cnt = n_anchors.to(torch.int32).contiguous()
    beta = torch.from_numpy(beta_table(k, bandwidth).copy()).to(dev)
    kw = dict(window=window, k=k, max_dist=max_dist, bandwidth=bandwidth)
    if dev.type == "cpu":
        return chain_and_extents_torch(q, t, cnt, beta, **kw)
    if dev.type == "cuda":
        if q.shape[1] > 512:
            raise ValueError(f"chain kernel takes at most 512 anchors per "
                             f"row; got {q.shape[1]}")
        return _chain_cuda(q, t, cnt, beta, **kw)
    raise ValueError(f"chain_and_extents: unsupported device {dev}")


chain_and_extents.launches = 0

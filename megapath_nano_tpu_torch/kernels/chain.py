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
its kernel launches in `chain_and_extents.launches`. The table is uploaded
once per device (`beta_tensor`), and int16 or int32 positions go to the
kernel as they are, so a launch on the card is the kernel alone: no copy
from the host, no wait for the stream, no conversion.

`chain_and_extents_ring` is the kernel's own order of operations (the
window as a ring over a warp's lanes, the rotated pick, the early end, the
running best) in plain PyTorch; only the CPU tests call it.
"""

from __future__ import annotations

import functools
import threading

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


def chain_and_extents_ring(q_pos, t_pos, n_anchors, beta, *, window, k,
                           max_dist, bandwidth):
    """The kernel's order of operations in plain PyTorch, for the CPU tests
    (no path calls it; it shares no code with `chain_and_extents_torch`).

    A warp's 32 lanes are the second axis. The window is a ring: anchor j
    lives in lane 31 - (j & 31), so at step i the anchor in lane l is
    1 + ((i + l) & 31) steps old; it is masked when older than
    min(window, i). The gap term of step i + 1 is formed during step i,
    after anchor i's positions entered the ring and before its f does; a
    masked lane carries NEG as its gap term and its sum with f stays below
    every real candidate. The pick is the maximum, the lanes that tie for
    it as a ballot rotated left by i & 31, and the highest set bit of that:
    the oldest. A group stops at its own count; the best anchor's index and
    chain (first on ties, anchor 0 without a score for an empty group) are
    carried along, and its position is read at the end."""
    i32 = torch.int32
    q = q_pos.to(i32)
    t = t_pos.to(i32)
    n, a = q.shape
    dev = q.device
    na = n_anchors.to(i32).clamp(0, a)
    lane = torch.arange(32, dtype=torch.int64, device=dev)[None, :]

    def ring(fill):
        return torch.full((n, 32), fill, dtype=i32, device=dev)

    rq, rt, rf = ring(0), ring(0), ring(NEG)
    rqmin, rtmin, rcnt = ring(0), ring(0), ring(0)
    qi, ti = q[:, 0], t[:, 0]
    pre = ring(NEG)
    bf = torch.full((n,), NEG, dtype=i32, device=dev)
    bi = torch.zeros(n, dtype=torch.int64, device=dev)
    bqmin, btmin = qi, ti
    bcnt = torch.ones(n, dtype=i32, device=dev)
    zeros = torch.zeros(n, dtype=i32, device=dev)

    def pick(w, j):
        return torch.gather(w, 1, j[:, None])[:, 0]

    for i in range(int(na.max()) if n else 0):
        li = i & 31
        mine = 31 - li
        # the serial part: best predecessor, oldest on ties
        cand = rf + pre
        m = cand.amax(dim=1)
        tied = ((cand == m[:, None]).long() << lane).sum(dim=1)   # ballot
        rot = ((tied << li) | (tied >> (32 - li))) & 0xFFFFFFFF
        top = torch.where((rot[:, None] >> lane) & 1 == 1, lane, -1).amax(
            dim=1)                                   # 31 - clz(rot)
        winner = (top - li) & 31
        # positions only: anchor i enters the ring, gap terms of step i + 1
        rq[:, mine], rt[:, mine] = qi, ti
        nx = i + 1
        qn, tn = (q[:, nx], t[:, nx]) if nx < a else (zeros, zeros)
        dq = qn[:, None] - rq
        dt = tn[:, None] - rt
        dd = (dq - dt).abs()
        ok = (((nx + lane) & 31) < min(window, nx)) & (dq > 0) & (dt > 0) \
            & (dq <= max_dist) & (dt <= max_dist) & (dd <= bandwidth)
        gap = torch.clamp(torch.minimum(dq, dt), max=k) \
            - beta[dd.clamp(max=bandwidth).long()]
        # the winner's chain start and length; anchor i's state
        has = m >= k
        fi = torch.clamp(m, min=k)
        qmin_i = torch.where(has, pick(rqmin, winner), qi)
        tmin_i = torch.where(has, pick(rtmin, winner), ti)
        cnt_i = torch.where(has, pick(rcnt, winner) + 1, 1)
        rf[:, mine], rqmin[:, mine], rtmin[:, mine], rcnt[:, mine] = \
            fi, qmin_i, tmin_i, cnt_i
        better = (i < na) & (fi > bf)     # a group past its count has ended
        bf = torch.where(better, fi, bf)
        bi = torch.where(better, i, bi)
        bqmin = torch.where(better, qmin_i, bqmin)
        btmin = torch.where(better, tmin_i, btmin)
        bcnt = torch.where(better, cnt_i, bcnt)
        qi, ti, pre = qn, tn, torch.where(ok, gap, NEG)

    return torch.stack([torch.clamp(bf, min=0), bqmin, pick(q, bi), btmin,
                        pick(t, bi), bcnt]).to(i32)


_beta_lock = threading.Lock()
_beta_tensors: dict[tuple[int, int, torch.device], torch.Tensor] = {}


def beta_tensor(k: int, bandwidth: int, device) -> torch.Tensor:
    """`beta_table(k, bandwidth)` as an int32 tensor on `device`, uploaded
    once per (k, bandwidth, device) and kept: after the first call a launch
    makes no host-to-device copy. Read-only by convention."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (k, bandwidth, dev)
    got = _beta_tensors.get(key)
    if got is None:
        with _beta_lock:          # the map path calls from two threads
            got = _beta_tensors.get(key)
            if got is None:
                got = torch.from_numpy(
                    beta_table(k, bandwidth).copy()).to(key[2])
                _beta_tensors[key] = got
    return got


def _chain_cuda(q, t, cnt, beta, *, window, k, max_dist, bandwidth):
    """Launch the kernel on contiguous (N, A) int16 or int32 planes of one
    type, (N,) int32 counts and the device's beta table."""
    lib = build.load()
    n, a = q.shape
    out = torch.empty((6, n), dtype=torch.int32, device=q.device)
    if n == 0:
        return out
    device, stream = build.launch_args(q)
    build.check(lib.mpn_chain(
        q.data_ptr(), t.data_ptr(), cnt.data_ptr(), beta.data_ptr(),
        out.data_ptr(), n, a, q.element_size(), window, k, max_dist,
        bandwidth, device, stream), "mpn_chain")
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
    kw = dict(window=window, k=k, max_dist=max_dist, bandwidth=bandwidth)
    cnt = n_anchors.to(torch.int32).contiguous()
    if dev.type == "cpu":
        return chain_and_extents_torch(
            q_pos.to(torch.int32), t_pos.to(torch.int32), cnt,
            beta_tensor(k, bandwidth, dev), **kw)
    if dev.type == "cuda":
        # the kernel marks a masked predecessor by adding -2**28 to its f
        if k * (q_pos.shape[1] + bandwidth) >= 2 ** 27:
            raise ValueError(f"chain kernel: k * (anchors per row + bandwidth)"
                             f" must stay below 2**27; got k={k}, "
                             f"{q_pos.shape[1]} anchors, bandwidth "
                             f"{bandwidth}")
        # it reads int16 and int32 planes as they are
        if q_pos.dtype != t_pos.dtype or \
                q_pos.dtype not in (torch.int16, torch.int32):
            q_pos, t_pos = q_pos.to(torch.int32), t_pos.to(torch.int32)
        return _chain_cuda(q_pos.contiguous(), t_pos.contiguous(), cnt,
                           beta_tensor(k, bandwidth, dev), **kw)
    raise ValueError(f"chain_and_extents: unsupported device {dev}")


chain_and_extents.launches = 0

"""Batched banded local affine-gap Smith-Waterman: full path statistics
(`banded_sw_full`) and score only (`banded_sw_scores`).

Port of megapath_nano_tpu.kernels.sw. The TPU kernel `_sw_kernel_full`
becomes the hand-written CUDA kernel in `csrc/sw_full.cu`, and `_sw_kernel`
the one in `csrc/sw_scores.cu`. `banded_sw_full_torch` and
`banded_sw_scores_torch` are their plain PyTorch versions, row loops over
the same recurrences (`_row_step_full_factory` / `_row_step_factory`,
`_reduce_best`, `_full_outputs` of the TPU package). The two row steps
differ in the carried E: the full-stats step zeroes it on dead (sentinel 5)
slots, the score-only step does not.

Each wrapper dispatches on where the tensors lie: on the CPU it runs the
plain version, on a CUDA device it launches the kernel (or raises). It counts
its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from megapath_nano_tpu_torch.kernels import build

NEG = -(2 ** 29)


def _pad_cols(x: torch.Tensor, left: int, right: int, value: int):
    parts = []
    if left:
        parts.append(torch.full((x.shape[0], left), value, dtype=x.dtype,
                                device=x.device))
    parts.append(x)
    if right:
        parts.append(torch.full((x.shape[0], right), value, dtype=x.dtype,
                                device=x.device))
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def _prepare(reads, read_lens, refs, ref_lens, band):
    """The TPU wrapper's padding (kernels/sw.py:372-390 of the TPU package):
    reads to a 128 multiple with 4, refs to >= q_max and a 128 multiple with
    5, then band/2 of sentinel 5 on each side and every column past the
    ref's length set to 5."""
    n, q_max = reads.shape
    t_max = refs.shape[1]
    half = band // 2
    if band % 128 or not 0 < band <= 1024:
        raise ValueError(f"band must be a multiple of 128 in [128, 1024]; "
                         f"got {band}")
    q_pad = (-q_max) % 128
    reads = _pad_cols(reads.to(torch.int8), 0, q_pad, 4)
    q_max += q_pad
    t_need = max(t_max, q_max)
    t_pad = (-t_need) % 128 + (t_need - t_max)
    refs = _pad_cols(refs.to(torch.int8), 0, t_pad, 5)
    t_max += t_pad
    refs_padded = _pad_cols(refs, half, half, 5)
    col = torch.arange(t_max + band, dtype=torch.int32,
                       device=refs.device)[None, :]
    ref_lens = ref_lens.to(torch.int32)
    refs_padded = torch.where(col >= ref_lens[:, None] + half,
                              torch.tensor(5, dtype=torch.int8,
                                           device=refs.device), refs_padded)
    return (reads.contiguous(), read_lens.to(torch.int32).contiguous(),
            refs_padded.contiguous())


def _same_device(reads, read_lens, refs, ref_lens):
    dev = reads.device
    for name, t in (("read_lens", read_lens), ("refs", refs),
                    ("ref_lens", ref_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, reads on {dev}")
    return dev


def _shift_left1(x, fill):
    """out[:, k] = x[:, k+1], fill in the last slot."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shift_right(x, s, fill):
    """out[:, k] = x[:, k-s], fill in the first s slots."""
    return torch.cat([torch.full_like(x[:, :s], fill), x[:, :-s]], dim=1)


def banded_sw_full_torch(reads, read_lens, refs_padded, *, band, match,
                         mismatch, gap_open, gap_extend):
    """Plain PyTorch version of the kernel on prepared inputs: reads
    (N, q_max) int8, read_lens (N,) int32, refs_padded (N, t_max + band)
    int8. Returns (N, 7) int32.

    Pairs with no read row never change the all-zero DP state, so they are
    written as the constant no-alignment row without running; the rest run
    to their longest read (later rows are no-ops under the `active` mask)."""
    n, q_max = reads.shape
    half = band // 2
    dev = reads.device
    i32 = torch.int32
    out = torch.tensor([0, 0, -half, 0, 0, -band, -band], dtype=i32,
                       device=dev).repeat(n, 1)
    rlen_all = read_lens.clamp(0, q_max)
    act = torch.nonzero(rlen_all > 0).flatten()
    if act.numel() == 0:
        return out
    R = reads[act].to(i32)
    T = refs_padded[act].to(i32)
    rlen = rlen_all[act][:, None]
    m = act.numel()
    lane = torch.arange(band, dtype=i32, device=dev)[None, :]
    z = torch.zeros((m, band), dtype=i32, device=dev)
    h_prev, e_prev, p_h, b_h, p_e, b_e = z, z, z, z, z, z
    best_v, best_i_v, best_p_v, best_b_v = z, z, z, z
    for i in range(int(rlen.max())):
        read_col = R[:, i:i + 1]
        ref_slice = T[:, i:i + band]
        is_ambig = (read_col == 4) | (ref_slice >= 4)
        sub = torch.where(is_ambig, 0, torch.where(
            read_col == ref_slice, match, -mismatch).to(i32))
        dead = ref_slice == 5
        is_match = (read_col == ref_slice) & ~is_ambig
        cur_j = i + lane - half
        cur_b = (i + band) * 32768 + (cur_j + band)

        mm = h_prev + sub
        fresh = h_prev == 0
        inc = torch.where(is_match, 1 << 16, 1).to(i32)
        p_m = torch.where(fresh, 0, p_h) + inc
        b_m = torch.where(fresh, cur_b, b_h)

        eo = _shift_left1(h_prev, NEG) - gap_open
        ee = _shift_left1(e_prev, NEG) - gap_extend
        e = torch.maximum(eo, ee)
        take_ext = ee >= eo
        p_e_new = torch.where(take_ext, _shift_left1(p_e, 0),
                              _shift_left1(p_h, 0)) + 1
        b_e_new = torch.where(take_ext, _shift_left1(b_e, 0),
                              _shift_left1(b_h, 0))

        take_m = mm >= e
        h_nod = torch.maximum(mm, e)
        p_nod = torch.where(take_m, p_m, p_e_new)
        b_nod = torch.where(take_m, b_m, b_e_new)
        h_nod = torch.where(dead, NEG, h_nod)

        g = h_nod - gap_open + lane * gap_extend
        y = _shift_right(g, 1, NEG)
        yp = _shift_right(p_nod + (band - lane), 1, 0)
        yb = _shift_right(b_nod, 1, 0)
        s = 1
        while s < band:
            ys = _shift_right(y, s, NEG)
            take = ys >= y
            y = torch.where(take, ys, y)
            yp = torch.where(take, _shift_right(yp, s, 0), yp)
            yb = torch.where(take, _shift_right(yb, s, 0), yb)
            s *= 2
        f = y - (lane - 1) * gap_extend
        p_f = yp + lane - band

        take_nod = h_nod >= f
        h = torch.maximum(h_nod, f)
        p_hx = torch.where(take_nod, p_nod, p_f)
        b_hx = torch.where(take_nod, b_nod, yb)
        h = torch.where(dead, 0, torch.clamp(h, min=0))
        pos = h > 0
        p_h_new = torch.where(pos, p_hx, 0)
        b_h_new = torch.where(pos, b_hx, cur_b)
        e_row = torch.where(dead, 0, torch.clamp(e, min=0))

        active = i < rlen
        h_prev = torch.where(active, h, h_prev)
        e_prev = torch.where(active, e_row, e_prev)
        p_h = torch.where(active, p_h_new, p_h)
        b_h = torch.where(active, b_h_new, b_h)
        p_e = torch.where(active, p_e_new, p_e)
        b_e = torch.where(active, b_e_new, b_e)

        improved = (h_prev > best_v) & active
        best_v = torch.where(improved, h_prev, best_v)
        best_i_v = torch.where(improved, i, best_i_v)
        best_p_v = torch.where(improved, p_h, best_p_v)
        best_b_v = torch.where(improved, b_h, best_b_v)

    # (max score, min row, min slot); companions taken before zeroing
    best = best_v.amax(dim=1, keepdim=True)
    at_s = best_v == best
    best_i = torch.where(at_s, best_i_v, 2 ** 30).amin(dim=1, keepdim=True)
    at_si = at_s & (best_i_v == best_i)
    best_k = torch.where(at_si, lane, band).amin(dim=1, keepdim=True)
    at_k = lane == best_k
    best_p = torch.where(at_k, best_p_v, 0).sum(dim=1, keepdim=True,
                                                dtype=i32)
    best_b = torch.where(at_k, best_b_v, 0).sum(dim=1, keepdim=True,
                                                dtype=i32)
    none = best <= 0
    best = torch.where(none, 0, best)
    best_i = torch.where(none, 0, best_i)
    best_k = torch.where(none, 0, best_k)
    n_match = torch.div(best_p, 65536, rounding_mode="floor")
    b_hi = torch.div(best_b, 32768, rounding_mode="floor")
    res = torch.cat([best, best_i, best_i + best_k - half, n_match,
                     best_p - n_match * 65536, b_hi - band,
                     best_b - b_hi * 32768 - band], dim=1).to(i32)
    out[act] = res
    return out


def _sw_full_cuda(reads, read_lens, refs_padded, *, band, match, mismatch,
                  gap_open, gap_extend):
    lib = build.load()
    n, q_max = reads.shape
    out = torch.empty((n, 7), dtype=torch.int32, device=reads.device)
    device, stream = build.launch_args(reads)
    build.check(lib.mpn_sw_full(
        reads.data_ptr(), read_lens.data_ptr(), refs_padded.data_ptr(),
        out.data_ptr(), n, q_max, refs_padded.shape[1], band, match,
        mismatch, gap_open, gap_extend, device, stream), "mpn_sw_full")
    build.count_launch(banded_sw_full)
    return out


def banded_sw_full(reads, read_lens, refs, ref_lens, *, band: int = 128,
                   match: int = 2, mismatch: int = 4, gap_open: int = 4,
                   gap_extend: int = 2, batch_tile: int = 64):
    """Batched banded local SW with full per-alignment statistics.

    reads (N, q_max) int8 padded with 4, read_lens (N,), refs (N, t_max)
    int8 padded with 5, ref_lens (N,). Returns (N, 7) int32 columns: score,
    end_read, end_ref, n_match, n_edit, begin_read, begin_ref (inclusive,
    window-local), bit-equal to the TPU package's banded_sw_full. A pair
    with no positive cell reports begin = -band and end_ref = -band/2.
    batch_tile is accepted for signature parity and not used."""
    del batch_tile
    dev = _same_device(reads, read_lens, refs, ref_lens)
    if reads.shape[1] + band >= 2 ** 15 or refs.shape[1] + band >= 2 ** 15:
        raise ValueError("full-stats kernel packing needs windows < 32k")
    reads, read_lens, refs_padded = _prepare(reads, read_lens, refs,
                                             ref_lens, band)
    kw = dict(band=band, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if dev.type == "cpu":
        return banded_sw_full_torch(reads, read_lens, refs_padded, **kw)
    if dev.type == "cuda":
        return _sw_full_cuda(reads, read_lens, refs_padded, **kw)
    raise ValueError(f"banded_sw_full: unsupported device {dev}")


banded_sw_full.launches = 0


def banded_sw_scores_torch(reads, read_lens, refs_padded, *, band, match,
                           mismatch, gap_open, gap_extend):
    """Plain PyTorch version of the score-only kernel on prepared inputs
    (see banded_sw_full_torch). Returns (3, N) int32 rows [score, end_read,
    end_ref]. Pairs with no read row are written as the constant
    no-alignment column (0, 0, -band/2) without running."""
    n, q_max = reads.shape
    half = band // 2
    dev = reads.device
    i32 = torch.int32
    out = torch.tensor([0, 0, -half], dtype=i32,
                       device=dev)[:, None].repeat(1, n)
    rlen_all = read_lens.clamp(0, q_max)
    act = torch.nonzero(rlen_all > 0).flatten()
    if act.numel() == 0:
        return out
    R = reads[act].to(i32)
    T = refs_padded[act].to(i32)
    rlen = rlen_all[act][:, None]
    lane = torch.arange(band, dtype=i32, device=dev)[None, :]
    z = torch.zeros((act.numel(), band), dtype=i32, device=dev)
    h_prev, e_prev, best_v, best_i_v = z, z, z, z
    for i in range(int(rlen.max())):
        read_col = R[:, i:i + 1]
        ref_slice = T[:, i:i + band]
        is_ambig = (read_col == 4) | (ref_slice >= 4)
        sub = torch.where(is_ambig, 0, torch.where(
            read_col == ref_slice, match, -mismatch).to(i32))
        dead = ref_slice == 5

        m = h_prev + sub
        e = torch.maximum(_shift_left1(h_prev, NEG) - gap_open,
                          _shift_left1(e_prev, NEG) - gap_extend)
        h_nod = torch.where(dead, NEG, torch.maximum(m, e))

        # F closed form: exclusive prefix-max of g, floored at NEG
        g = h_nod - gap_open + lane * gap_extend
        y = _shift_right(torch.cummax(g, dim=1).values, 1, NEG).clamp(min=NEG)
        f = y - (lane - 1) * gap_extend
        h = torch.clamp(torch.maximum(h_nod, f), min=0)
        h = torch.where(dead, 0, h)

        active = i < rlen
        h_prev = torch.where(active, h, h_prev)
        # E is not zeroed on dead slots here (the full-stats step does)
        e_prev = torch.where(active, torch.clamp(e, min=0), e_prev)
        improved = (h_prev > best_v) & active
        best_v = torch.where(improved, h_prev, best_v)
        best_i_v = torch.where(improved, i, best_i_v)

    # (max score, min row, min slot)
    best = best_v.amax(dim=1, keepdim=True)
    at_s = best_v == best
    best_i = torch.where(at_s, best_i_v, 2 ** 30).amin(dim=1, keepdim=True)
    at_si = at_s & (best_i_v == best_i)
    best_k = torch.where(at_si, lane, band).amin(dim=1, keepdim=True)
    none = best <= 0
    best = torch.where(none, 0, best)
    best_i = torch.where(none, 0, best_i)
    best_k = torch.where(none, 0, best_k)
    out[:, act] = torch.cat([best, best_i, best_i + best_k - half],
                            dim=1).to(i32).T
    return out


def _sw_scores_cuda(reads, read_lens, refs_padded, *, band, match, mismatch,
                    gap_open, gap_extend):
    lib = build.load()
    n, q_max = reads.shape
    out = torch.empty((3, n), dtype=torch.int32, device=reads.device)
    device, stream = build.launch_args(reads)
    build.check(lib.mpn_sw_scores(
        reads.data_ptr(), read_lens.data_ptr(), refs_padded.data_ptr(),
        out.data_ptr(), n, q_max, refs_padded.shape[1], band, match,
        mismatch, gap_open, gap_extend, device, stream), "mpn_sw_scores")
    build.count_launch(banded_sw_scores)
    return out


def banded_sw_scores(reads, read_lens, refs, ref_lens, *, band: int = 128,
                     match: int = 2, mismatch: int = 4, gap_open: int = 4,
                     gap_extend: int = 2):
    """Batched banded local SW, score only. Arguments as banded_sw_full, with
    no limit on the window sizes below 2**22 rows. Returns (scores, end_read,
    end_ref), three (N,) int32 tensors, bit-equal to the TPU package's
    banded_sw_scores. A pair with no positive cell reports (0, 0, -band/2).

    The band is centered on the main diagonal: at read position i it covers
    ref positions [i - band/2, i + band/2). The TPU wrapper's batch_tile has
    no counterpart: one thread block serves one pair."""
    dev = _same_device(reads, read_lens, refs, ref_lens)
    if reads.shape[1] + 128 >= 2 ** 22:
        raise ValueError("score-only kernel takes reads below 2**22 rows")
    reads, read_lens, refs_padded = _prepare(reads, read_lens, refs,
                                             ref_lens, band)
    kw = dict(band=band, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if dev.type == "cpu":
        out = banded_sw_scores_torch(reads, read_lens, refs_padded, **kw)
    elif dev.type == "cuda":
        out = _sw_scores_cuda(reads, read_lens, refs_padded, **kw)
    else:
        raise ValueError(f"banded_sw_scores: unsupported device {dev}")
    return out[0], out[1], out[2]


banded_sw_scores.launches = 0

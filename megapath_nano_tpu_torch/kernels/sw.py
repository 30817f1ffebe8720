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
plain version (on `_prepare`'s padded copy, as the TPU wrapper pads), on a
CUDA device it launches the kernel on the caller's windows (or raises). It
counts its kernel launches in `<wrapper>.launches`, and
`banded_sw_scores.packed_launches` counts those whose pairs may walk the
score-only kernel's packed rows.

The CUDA kernels walk a row in another order than the reference: each lane
of a warp owns band / 32 consecutive slots, the F chain is a scan inside the
lane, a scan over the lane totals and a second walk, and the running best is
kept per lane. `f_chain_blocked`, `f_max_blocked`, `lane_best_update` and
`lane_best_reduce` spell those pieces out in plain PyTorch, apart from the
plain versions, so that a CPU test can hold them to the reference's order.
"""

from __future__ import annotations

import ctypes
import functools

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


def _check_band(band):
    if band % 128 or band <= 0:
        raise ValueError(f"band must be a positive multiple of 128; got "
                         f"{band}")


def _prepare(reads, read_lens, refs, ref_lens, band):
    """The TPU wrapper's padding (kernels/sw.py:372-390 of the TPU package):
    reads to a 128 multiple with 4, refs to >= q_max and a 128 multiple with
    5, then band/2 of sentinel 5 on each side and every column past the
    ref's length set to 5."""
    n, q_max = reads.shape
    t_max = refs.shape[1]
    half = band // 2
    _check_band(band)
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


def _keep_left(left, right):
    """The F chain's combine on (g, p, b) tuples: the left operand stays
    when left.g >= right.g (the earlier slot wins ties), else the right."""
    take = left[0] >= right[0]
    return tuple(torch.where(take, a, b) for a, b in zip(left, right))


def f_chain_blocked(g, gp, gb, slots):
    """The F chain of one full-stats row in the order of the CUDA kernel's
    warp-per-pair form (csrc/sw_full.cu), where `banded_sw_full_torch` runs
    a Hillis-Steele scan: band / slots lanes of `slots` consecutive slots
    each; a sequential scan inside each lane for the lane totals, a
    doubling scan over the lane totals, the exclusive prefix seeded with
    the fill (NEG, 0, 0) left of slot 0, then a second walk over each
    lane's slots that applies the prefix. `_keep_left` picks the leftmost
    maximum, which does not depend on the grouping. Takes the (N, band)
    planes g, gp, gb and returns (y, yp, yb). No path calls it: a CPU test
    holds it to the reference's order."""
    n, band = g.shape
    lanes = band // slots
    x = [t.reshape(n, lanes, slots) for t in (g, gp, gb)]
    total = tuple(t[:, :, 0] for t in x)
    for j in range(1, slots):
        total = _keep_left(total, tuple(t[:, :, j] for t in x))
    lane = torch.arange(lanes, dtype=torch.int32, device=g.device)[None, :]
    s = 1
    while s < lanes:
        moved = (_shift_right(total[0], s, NEG), _shift_right(total[1], s, 0),
                 _shift_right(total[2], s, 0))
        merged = _keep_left(moved, total)
        total = tuple(torch.where(lane >= s, a, b)
                      for a, b in zip(merged, total))
        s *= 2
    run = (_shift_right(total[0], 1, NEG), _shift_right(total[1], 1, 0),
           _shift_right(total[2], 1, 0))
    fill = (lane == 0) | (run[0] <= NEG)
    run = (torch.where(fill, NEG, run[0]), torch.where(fill, 0, run[1]),
           torch.where(fill, 0, run[2]))
    out = [torch.empty_like(t) for t in x]
    for j in range(slots):
        for o, r in zip(out, run):
            o[:, :, j] = r
        run = _keep_left(run, tuple(t[:, :, j] for t in x))
    return tuple(o.reshape(n, band) for o in out)


def f_max_blocked(g, slots):
    """The F chain of one score-only row (exclusive prefix maximum of g,
    floored at NEG) in the order of csrc/sw_scores.cu: a running maximum
    (from NEG) inside each lane, a doubling maximum scan over the lane
    totals, NEG left of slot 0, then the prefix applied slot by slot."""
    n, band = g.shape
    lanes = band // slots
    x = g.reshape(n, lanes, slots)
    total = torch.full_like(x[:, :, 0], NEG)
    for j in range(slots):
        total = torch.maximum(total, x[:, :, j])
    lane = torch.arange(lanes, dtype=torch.int32, device=g.device)[None, :]
    s = 1
    while s < lanes:
        moved = _shift_right(total, s, NEG)
        total = torch.where((lane >= s) & (moved > total), moved, total)
        s *= 2
    run = _shift_right(total, 1, NEG)
    out = torch.empty_like(x)
    for j in range(slots):
        out[:, :, j] = run
        run = torch.maximum(run, x[:, :, j])
    return out.reshape(n, band)


def lane_best_update(state, h, i, extra, active, slots):
    """The running best as the CUDA kernels keep it, one per lane of `slots`
    consecutive slots: state is [value, row, slot, *extra] of (N, band /
    slots) planes, or None before the first row. Row i's H (and its
    companions `extra`, (N, band) each) is walked in ascending slot order
    with a strict >, so the earliest row of a maximum and the smallest slot
    of that row stay."""
    n, band = h.shape
    first = torch.arange(0, band, slots, dtype=torch.int32,
                         device=h.device)[None, :]
    if state is None:
        z = torch.zeros((n, band // slots), dtype=torch.int32, device=h.device)
        state = [z, z, first.expand_as(z)] + [z] * len(extra)
    hs = h.reshape(n, -1, slots)
    es = [x.reshape(n, -1, slots) for x in extra]
    for j in range(slots):
        improved = (hs[:, :, j] > state[0]) & active
        new = [hs[:, :, j], i, first + j] + [x[:, :, j] for x in es]
        state = [torch.where(improved, a, b) for a, b in zip(new, state)]
    return state


def lane_best_reduce(state, band):
    """The kernels' final reduction over the per-lane bests: (max value, min
    row, min slot), and `extra` at the winner, as (N, 1) columns [best,
    best_i, best_k, *extra]. The companions are taken before a no-alignment
    result is zeroed."""
    best_v, best_i_v, slot, *extra = state
    best = best_v.amax(dim=1, keepdim=True)
    at_s = best_v == best
    best_i = torch.where(at_s, best_i_v, 2 ** 30).amin(dim=1, keepdim=True)
    at_si = at_s & (best_i_v == best_i)
    best_k = torch.where(at_si, slot, band).amin(dim=1, keepdim=True)
    at_k = at_si & (slot == best_k)
    extra = [torch.where(at_k, x, 0).sum(dim=1, keepdim=True,
                                         dtype=torch.int32) for x in extra]
    none = best <= 0
    return [torch.where(none, 0, x) for x in (best, best_i, best_k)] + extra


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


# Forms of the two CUDA kernels (csrc/sw_full.cu, csrc/sw_scores.cu): a warp
# per pair, a block per pair with its planes in shared memory, a block per
# pair with its planes in a scratch of device memory. The wrappers always
# pass FORM_BY_SHAPE (`pick_form`); the others let a check on the card hold
# each form to the plain version and time one against the other.
FORM_BY_SHAPE, FORM_WARP, FORM_BLOCK, FORM_BLOCK_DEVICE = 0, 1, 2, 3
WARP_BANDS = (128, 256, 512)    # the bands with a warp-per-pair form
# int32 planes of the band a pair of the block-per-pair form keeps
PLANES = {"mpn_sw_full": 12, "mpn_sw_scores": 4}
# the most device memory the device-memory block form takes for its planes
# (the pairs beyond it go in further launches of the same kernel)
SCRATCH_BYTES = 256 << 20


@functools.lru_cache(maxsize=None)
def block_max_band(entry: str, device: int) -> int:
    """The largest band the block-per-pair form of `entry` takes on CUDA
    device `device` with its state in shared memory: planes of band int32
    (12 for sw_full, 4 for sw_scores) in what one block may have. Past it
    the planes go to device memory (FORM_BLOCK_DEVICE)."""
    lib = build.load()
    band = ctypes.c_int(0)
    build.check(getattr(lib, entry + "_max_band")(device, ctypes.byref(band)),
                entry + "_max_band")
    return band.value


def _word_rows(x, fill):
    """x as the CUDA kernels read it: int8, contiguous, every row a whole
    number of 32-bit words (padded with `fill`) from a 4-byte aligned base.
    The map path's planes already are, and pass through untouched."""
    x = _pad_cols(x.to(torch.int8), 0, (-x.shape[1]) % 4, fill).contiguous()
    return x if x.data_ptr() % 4 == 0 else x.clone()


def pick_form(entry, form, band, limit):
    """The form a launch of `entry` at `band` takes, `limit` being its
    block_max_band: FORM_BY_SHAPE picks the warp form for 128, 256 and 512,
    the block form with shared-memory planes up to `limit` and the one with
    device-memory planes beyond, so every positive multiple of 128 has a
    kernel. A form asked for by name must exist for the band."""
    _check_band(band)
    if form == FORM_BY_SHAPE:
        if band in WARP_BANDS:
            return FORM_WARP
        return FORM_BLOCK if band <= limit else FORM_BLOCK_DEVICE
    if form == FORM_WARP and band not in WARP_BANDS:
        raise ValueError(f"{entry}: no warp-per-pair form at band {band}")
    if form == FORM_BLOCK and band > limit:
        raise ValueError(
            f"{entry}: band {band} does not fit in a block's shared memory; "
            f"this card takes bands up to {limit} in that form")
    if form not in (FORM_WARP, FORM_BLOCK, FORM_BLOCK_DEVICE):
        raise ValueError(f"{entry}: unknown form {form}")
    return form


def scratch_blocks(entry, n, band):
    """Blocks a launch of the device-memory block form holds planes for: all
    n pairs, or as many as SCRATCH_BYTES takes (at least one)."""
    per_pair = 4 * PLANES[entry] * band
    return max(1, min(n, SCRATCH_BYTES // per_pair))


def _launch(entry, wrapper, out_shape, reads, read_lens, refs, ref_lens, *,
            band, match, mismatch, gap_open, gap_extend, form, flag=None):
    """Launch one of the two extension kernels on the caller's windows: the
    kernels form the dead cells left of a window and past its length
    themselves, so no padded copy (`_prepare`) is made on this route.
    `flag`, a ctypes int, is passed by reference as the last argument
    (mpn_sw_scores reports there whether it allowed packed rows)."""
    device, stream = build.launch_args(reads)
    form = pick_form(entry, form, band, block_max_band(entry, device))
    n = reads.shape[0]
    if refs.shape[0] != n or read_lens.shape != (n,) or ref_lens.shape != (n,):
        raise ValueError(f"{entry}: {n} reads, {refs.shape[0]} refs, lengths "
                         f"{tuple(read_lens.shape)}, {tuple(ref_lens.shape)}")
    lib = build.load()
    reads, refs = _word_rows(reads, 4), _word_rows(refs, 5)
    read_lens = read_lens.to(torch.int32).contiguous()
    ref_lens = ref_lens.to(torch.int32).contiguous()
    out = torch.empty(out_shape, dtype=torch.int32, device=reads.device)
    blocks, scratch = 0, None
    if form == FORM_BLOCK_DEVICE and n:
        # allocated on the current stream, which the launches run on: the
        # allocator hands the memory out again only to work queued after them
        blocks = scratch_blocks(entry, n, band)
        scratch = torch.empty(blocks * PLANES[entry] * band,
                              dtype=torch.int32, device=reads.device)
    build.check(getattr(lib, entry)(
        reads.data_ptr(), read_lens.data_ptr(), refs.data_ptr(),
        ref_lens.data_ptr(), out.data_ptr(), n, reads.shape[1], refs.shape[1],
        band, match, mismatch, gap_open, gap_extend, form,
        device, stream, None if scratch is None else scratch.data_ptr(),
        blocks, *(() if flag is None else (ctypes.byref(flag),))), entry)
    build.count_launch(wrapper)
    return out


def _sw_full_cuda(reads, read_lens, refs, ref_lens, *, form=FORM_BY_SHAPE,
                  **kw):
    return _launch("mpn_sw_full", banded_sw_full, (reads.shape[0], 7), reads,
                   read_lens, refs, ref_lens, form=form, **kw)


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
        raise ValueError("full-stats kernel packing needs windows < 32k (use "
                         "host emit)")
    kw = dict(band=band, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if dev.type == "cpu":
        return banded_sw_full_torch(
            *_prepare(reads, read_lens, refs, ref_lens, band), **kw)
    if dev.type == "cuda":
        return _sw_full_cuda(reads, read_lens, refs, ref_lens, **kw)
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


def _sw_scores_cuda(reads, read_lens, refs, ref_lens, *, form=FORM_BY_SHAPE,
                    **kw):
    packed = ctypes.c_int(0)
    out = _launch("mpn_sw_scores", banded_sw_scores, (3, reads.shape[0]),
                  reads, read_lens, refs, ref_lens, form=form, flag=packed,
                  **kw)
    if packed.value:
        build.count_launch(banded_sw_scores, "packed_launches")
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
    no counterpart: one warp (or, for very few pairs, one block) serves one
    pair."""
    dev = _same_device(reads, read_lens, refs, ref_lens)
    if reads.shape[1] + 128 >= 2 ** 22:
        raise ValueError("score-only kernel takes reads below 2**22 rows")
    kw = dict(band=band, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if dev.type == "cpu":
        out = banded_sw_scores_torch(
            *_prepare(reads, read_lens, refs, ref_lens, band), **kw)
    elif dev.type == "cuda":
        out = _sw_scores_cuda(reads, read_lens, refs, ref_lens, **kw)
    else:
        raise ValueError(f"banded_sw_scores: unsupported device {dev}")
    return out[0], out[1], out[2]


banded_sw_scores.launches = 0
# launches of the warp form whose pairs may walk packed rows: at bands 128,
# 256 and 512 under a scoring that the packing holds (csrc/sw_scores.cu,
# packed_rows_fit); a pair with a code other than 0..4 in its window walks
# exact rows all the same
banded_sw_scores.packed_launches = 0

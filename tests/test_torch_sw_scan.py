"""The order in which the CUDA extension kernels (warp-per-pair form) walk a
row, checked on the CPU: the F chain as a per-lane sequential scan, a scan
over the 32 lane totals and a second walk that applies the prefix
(`sw.f_chain_blocked`, `sw.f_max_blocked`), and the running best kept per
lane with one final reduction (`sw.lane_best_update`, `sw.lane_best_reduce`).
Held, for S = 4, 8, 16 slots a lane (band 128, 256, 512), against the
reference's order (the Hillis-Steele scan, a running best per slot): one
row at a time against a copy of the scan, and as a whole DP (the row steps
written out here around those pieces) against the plain versions, which
share no code with them, and against the TPU package with backend="jnp".
Inputs force ties: many equal values, values equal to and below NEG,
all-dead rows. Everything is an integer, so the tolerance is 0.

The score-only kernel's packed rows (csrc/sw_scores.cu, `walk_packed`) are
written out here in plain numpy too (`_sw_scores_packed_rows`) and held to
the same references."""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.kernels.sw import banded_sw_full as jax_sw_full
from megapath_nano_tpu.kernels.sw import banded_sw_scores as jax_sw_scores
from megapath_nano_tpu_torch.kernels import sw

PARAMS = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
NEG = sw.NEG
SLOTS = [4, 8, 16]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# one row of the F chain


def _scan_rows(case, band, rng):
    """(g, gp, gb) int32 (rows, band) whose g forces the tie rules."""
    rows = 48
    lane = np.arange(band)
    if case == "few_values":          # long runs of equal maxima
        g = rng.integers(-3, 3, (rows, band))
    elif case == "all_equal":
        g = np.full((rows, band), 7)
    elif case == "at_and_below_neg":  # the fill must win against <= NEG
        g = NEG + rng.integers(-4, 3, (rows, band))
    elif case == "all_dead":          # g of a dead row: NEG - o + k * e
        g = np.tile(NEG - 4 + 2 * lane, (rows, 1))
    elif case == "dead_prefix":       # dead slots left, live ones right
        cut = rng.integers(0, band, (rows, 1))
        g = np.where(lane[None, :] < cut, NEG - 4 + 2 * lane[None, :],
                     rng.integers(-8, 40, (rows, band)) - 4 + 2 * lane)
    elif case == "rising":            # every slot a new maximum
        g = np.tile(lane, (rows, 1)) + rng.integers(0, 2, (rows, band))
    elif case == "falling":           # slot 0 wins everywhere
        g = np.tile(-lane, (rows, 1))
    else:
        raise AssertionError(case)
    gp = rng.integers(0, 2 ** 20, (rows, band))
    gb = rng.integers(0, 2 ** 30, (rows, band))
    return tuple(torch.from_numpy(x.astype(np.int32)) for x in (g, gp, gb))


SCAN_CASES = ["few_values", "all_equal", "at_and_below_neg", "all_dead",
              "dead_prefix", "rising", "falling"]


def _f_chain_doubling(g, gp, gb):
    """The Hillis-Steele tuple scan as `banded_sw_full_torch` runs it."""
    y = sw._shift_right(g, 1, NEG)
    yp = sw._shift_right(gp, 1, 0)
    yb = sw._shift_right(gb, 1, 0)
    s = 1
    while s < g.shape[1]:
        ys = sw._shift_right(y, s, NEG)
        take = ys >= y
        y = torch.where(take, ys, y)
        yp = torch.where(take, sw._shift_right(yp, s, 0), yp)
        yb = torch.where(take, sw._shift_right(yb, s, 0), yb)
        s *= 2
    return y, yp, yb


def _f_max_doubling(g):
    """The closed form `banded_sw_scores_torch` uses."""
    return sw._shift_right(torch.cummax(g, dim=1).values, 1,
                           NEG).clamp(min=NEG)


def _leftmost_max_exclusive(g, gp, gb):
    """The scan's definition, slot by slot: the leftmost maximum of the
    fill (NEG, 0, 0) followed by the slots before k."""
    g, gp, gb = (x.numpy().astype(np.int64) for x in (g, gp, gb))
    y, yp, yb = np.zeros_like(g), np.zeros_like(g), np.zeros_like(g)
    for r in range(g.shape[0]):
        best = (NEG, 0, 0)
        for k in range(g.shape[1]):
            y[r, k], yp[r, k], yb[r, k] = best
            if g[r, k] > best[0]:
                best = (g[r, k], gp[r, k], gb[r, k])
    return y, yp, yb


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", SCAN_CASES)
def test_f_chain_blocked_equals_doubling(case, slots):
    band = 32 * slots
    rng = np.random.default_rng(100 * slots + SCAN_CASES.index(case))
    g, gp, gb = _scan_rows(case, band, rng)
    ref = _f_chain_doubling(g, gp, gb)
    got = sw.f_chain_blocked(g, gp, gb, slots)
    exp = _leftmost_max_exclusive(g, gp, gb)
    for a, b, c in zip(got, ref, exp):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), c)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", SCAN_CASES)
def test_f_max_blocked_equals_doubling(case, slots):
    band = 32 * slots
    rng = np.random.default_rng(200 * slots + SCAN_CASES.index(case))
    g, _, _ = _scan_rows(case, band, rng)
    got = sw.f_max_blocked(g, slots)
    assert torch.equal(got, _f_max_doubling(g))
    exp = np.maximum.accumulate(
        np.concatenate([np.full((len(g), 1), NEG), g.numpy()[:, :-1]],
                       axis=1), axis=1)
    np.testing.assert_array_equal(got.numpy(), exp)


# ---------------------------------------------------------------------------
# the whole DP in the kernel's order


def _rep(unit, n):
    return np.tile(np.array(unit, np.int8), n // len(unit) + 1)[:n]


def _tie_pairs(case, rng):
    """(read, ref) pairs, at most 120 rows, whose DP is full of ties."""
    if case == "homopolymer":         # every diagonal scores alike
        return [(_rep([0], 100), _rep([0], 150)),
                (_rep([0], 90), _rep([0], 40)),
                (np.concatenate([_rep([0], 50), _rep([1], 3),
                                 _rep([0], 50)]), _rep([0], 140))]
    if case == "short_repeats":       # an indel can sit anywhere in the run
        di, tri = _rep([0, 1], 160), _rep([0, 1, 2], 160)
        return [(di[:110].copy(), di), (di[1:111].copy(), di),
                (np.concatenate([tri[:45], tri[51:120]]), tri),
                (np.concatenate([tri[:45], tri[:6], tri[45:110]]), tri)]
    if case == "n_stretches":         # zero substitution score
        t = rng.integers(0, 4, 150).astype(np.int8)
        t_n = t.copy()
        t_n[40:75] = 4
        r_n = t[10:120].copy()
        r_n[30:60] = 4
        return [(np.full(100, 4, np.int8), t), (t[:90].copy(),
                                                np.full(120, 4, np.int8)),
                (t[5:115].copy(), t_n), (r_n, t)]
    if case == "dead_columns":        # refs of 0..3 bases, refs < band/2
        a = _rep([0], 110)
        return [(a, _rep([0], n)) for n in (0, 1, 2, 3, 17, 63)] \
            + [(np.zeros(0, np.int8), _rep([0], 50))]
    if case == "no_positive_cell":
        return [(_rep([0], 90), _rep([1], 110)), (_rep([2], 5), _rep([3], 9)),
                (_rep([0], 100), _rep([0], 150))]
    if case == "random_low_complexity":   # two-letter alphabet, 15% errors
        pairs = []
        for _ in range(6):
            t = rng.integers(0, 2, int(rng.integers(60, 160))).astype(np.int8)
            r = t[int(rng.integers(0, 20)):][:118].copy()
            flip = rng.random(len(r)) < 0.15
            r[flip] = rng.integers(0, 3, int(flip.sum()))
            pairs.append((r[rng.random(len(r)) > 0.05], t))
        return pairs
    raise AssertionError(case)


DP_CASES = ["homopolymer", "short_repeats", "n_stretches", "dead_columns",
            "no_positive_cell", "random_low_complexity"]


def _batch(pairs):
    q_max = max(1, max(len(r) for r, _ in pairs))
    t_max = max(1, max(len(t) for _, t in pairs))
    ra = np.full((len(pairs), q_max), 4, np.int8)
    ta = np.full((len(pairs), t_max), 5, np.int8)
    for i, (r, t) in enumerate(pairs):
        ra[i, : len(r)] = r
        ta[i, : len(t)] = t
    rl = np.array([len(r) for r, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    return ra, rl, ta, tl


def _sw_full_blocked(reads, read_lens, refs_padded, *, band, match, mismatch,
                     gap_open, gap_extend):
    """The full-stats DP on prepared inputs in the CUDA kernel's order: the
    reference's cell recurrence, the F chain by `sw.f_chain_blocked`, one
    running best a lane. Returns (N, 7) int32."""
    slots = band // 32
    half = band // 2
    i32 = torch.int32
    n = reads.shape[0]
    R, T = reads.to(i32), refs_padded.to(i32)
    rlen = read_lens.clamp(0, reads.shape[1])[:, None]
    lane = torch.arange(band, dtype=i32)[None, :]
    z = torch.zeros((n, band), dtype=i32)
    h_prev, e_prev, p_h, b_h, p_e, b_e = z, z, z, z, z, z
    best = sw.lane_best_update(None, z, 0, (z, z), rlen < 0, slots)
    for i in range(int(rlen.max())):
        read_col = R[:, i:i + 1]
        ref_slice = T[:, i:i + band]
        is_ambig = (read_col == 4) | (ref_slice >= 4)
        is_match = (read_col == ref_slice) & ~is_ambig
        sub = torch.where(is_ambig, 0,
                          torch.where(is_match, match, -mismatch)).to(i32)
        dead = ref_slice == 5
        cur_b = (i + band) * 32768 + (i + lane - half + band)

        mm = h_prev + sub
        fresh = h_prev == 0
        p_m = torch.where(fresh, 0, p_h) + torch.where(is_match, 1 << 16, 1)
        b_m = torch.where(fresh, cur_b, b_h)
        eo = sw._shift_left1(h_prev, NEG) - gap_open
        ee = sw._shift_left1(e_prev, NEG) - gap_extend
        take_ext = ee >= eo
        e = torch.maximum(eo, ee)
        p_e_new = torch.where(take_ext, sw._shift_left1(p_e, 0),
                              sw._shift_left1(p_h, 0)) + 1
        b_e_new = torch.where(take_ext, sw._shift_left1(b_e, 0),
                              sw._shift_left1(b_h, 0))
        take_m = mm >= e
        h_nod = torch.where(dead, NEG, torch.maximum(mm, e))
        p_nod = torch.where(take_m, p_m, p_e_new)
        b_nod = torch.where(take_m, b_m, b_e_new)

        g = h_nod - gap_open + lane * gap_extend
        y, yp, yb = sw.f_chain_blocked(g, p_nod + (band - lane), b_nod, slots)
        f = y - (lane - 1) * gap_extend
        take_nod = h_nod >= f
        h = torch.where(dead, 0, torch.clamp(torch.maximum(h_nod, f), min=0))
        pos = h > 0
        p_h_new = torch.where(pos & take_nod, p_nod,
                              torch.where(pos, yp + lane - band, 0))
        b_h_new = torch.where(pos, torch.where(take_nod, b_nod, yb), cur_b)
        e_row = torch.where(dead, 0, torch.clamp(e, min=0))

        active = i < rlen
        h_prev = torch.where(active, h, h_prev)
        e_prev = torch.where(active, e_row, e_prev)
        p_h = torch.where(active, p_h_new, p_h)
        b_h = torch.where(active, b_h_new, b_h)
        p_e = torch.where(active, p_e_new, p_e)
        b_e = torch.where(active, b_e_new, b_e)
        best = sw.lane_best_update(best, h_prev, i, (p_h, b_h), active, slots)

    score, best_i, best_k, best_p, best_b = sw.lane_best_reduce(best, band)
    n_match = best_p >> 16
    b_hi = best_b >> 15
    return torch.cat([score, best_i, best_i + best_k - half, n_match,
                      best_p & 0xFFFF, b_hi - band,
                      (best_b & 0x7FFF) - band], dim=1).to(i32)


def _sw_scores_blocked(reads, read_lens, refs_padded, *, band, match,
                       mismatch, gap_open, gap_extend):
    """The score-only DP in the kernel's order. Returns (3, N) int32."""
    slots = band // 32
    half = band // 2
    i32 = torch.int32
    n = reads.shape[0]
    R, T = reads.to(i32), refs_padded.to(i32)
    rlen = read_lens.clamp(0, reads.shape[1])[:, None]
    lane = torch.arange(band, dtype=i32)[None, :]
    z = torch.zeros((n, band), dtype=i32)
    h_prev, e_prev = z, z
    best = sw.lane_best_update(None, z, 0, (), rlen < 0, slots)
    for i in range(int(rlen.max())):
        read_col = R[:, i:i + 1]
        ref_slice = T[:, i:i + band]
        is_ambig = (read_col == 4) | (ref_slice >= 4)
        sub = torch.where(is_ambig, 0, torch.where(
            read_col == ref_slice, match, -mismatch)).to(i32)
        dead = ref_slice == 5
        e = torch.maximum(sw._shift_left1(h_prev, NEG) - gap_open,
                          sw._shift_left1(e_prev, NEG) - gap_extend)
        h_nod = torch.where(dead, NEG, torch.maximum(h_prev + sub, e))
        g = h_nod - gap_open + lane * gap_extend
        f = sw.f_max_blocked(g, slots) - (lane - 1) * gap_extend
        h = torch.where(dead, 0, torch.clamp(torch.maximum(h_nod, f), min=0))
        active = i < rlen
        h_prev = torch.where(active, h, h_prev)
        e_prev = torch.where(active, torch.clamp(e, min=0), e_prev)
        best = sw.lane_best_update(best, h_prev, i, (), active, slots)
    score, best_i, best_k = sw.lane_best_reduce(best, band)
    return torch.cat([score, best_i, best_i + best_k - half], dim=1).to(i32).T


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", DP_CASES)
def test_sw_full_blocked_equals_reference_order(case, slots):
    band = 32 * slots
    rng = np.random.default_rng(300 * slots + DP_CASES.index(case))
    arrays = _batch(_tie_pairs(case, rng))
    prepared = sw._prepare(*(torch.from_numpy(x) for x in arrays), band)
    got = _sw_full_blocked(*prepared, band=band, **PARAMS)
    ref = sw.banded_sw_full_torch(*prepared, band=band, **PARAMS)
    assert torch.equal(got, ref)
    jax_ref = np.asarray(jax_sw_full(*arrays, band=band, batch_tile=8,
                                     backend="jnp", **PARAMS))
    np.testing.assert_array_equal(got.numpy(), jax_ref)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", DP_CASES)
def test_sw_scores_blocked_equals_reference_order(case, slots):
    band = 32 * slots
    rng = np.random.default_rng(400 * slots + DP_CASES.index(case))
    arrays = _batch(_tie_pairs(case, rng))
    prepared = sw._prepare(*(torch.from_numpy(x) for x in arrays), band)
    got = _sw_scores_blocked(*prepared, band=band, **PARAMS)
    ref = sw.banded_sw_scores_torch(*prepared, band=band, **PARAMS)
    assert torch.equal(got, ref)
    jax_ref = np.stack([np.asarray(x) for x in jax_sw_scores(
        *arrays, band=band, batch_tile=8, backend="jnp", **PARAMS)])
    np.testing.assert_array_equal(got.numpy(), jax_ref)


@pytest.mark.parametrize("slots", SLOTS)
def test_blocked_order_other_scoring_ties(slots):
    """gap_open == gap_extend and mismatch == match make diagonal, E and F
    tie far more often than the default scoring does."""
    band = 32 * slots
    rng = np.random.default_rng(500 + slots)
    pairs = _tie_pairs("random_low_complexity", rng) \
        + _tie_pairs("short_repeats", rng)
    prepared = sw._prepare(*(torch.from_numpy(x) for x in _batch(pairs)),
                           band)
    for params in (dict(match=1, mismatch=1, gap_open=1, gap_extend=1),
                   dict(match=2, mismatch=2, gap_open=2, gap_extend=1)):
        assert torch.equal(
            _sw_full_blocked(*prepared, band=band, **params),
            sw.banded_sw_full_torch(*prepared, band=band, **params))
        assert torch.equal(
            _sw_scores_blocked(*prepared, band=band, **params),
            sw.banded_sw_scores_torch(*prepared, band=band, **params))


# ---------------------------------------------------------------------------
# the score-only kernel's packed rows


def _packed_row_pairs(case, rng):
    """Pairs for the packed rows beyond the tie cases: codes 0..4 only."""
    if case == "later_row_equal":   # the best recurs in later rows
        x = rng.integers(0, 4, 80).astype(np.int8)
        dip = x.copy()
        dip[20:22] = (dip[20:22] + 1) % 4     # -8, then +8 back over 4 rows
        dip[30:32] = (dip[30:32] + 2) % 4
        return [(dip[:60].copy(), x[:70].copy()),
                (np.concatenate([x[:12], (x[12:14] + 1) % 4, x[14:18],
                                 (x[18:20] + 3) % 4, x[20:24]]), x[:24]),
                (_rep([0, 1], 40), np.concatenate([_rep([0, 1], 20),
                                                  _rep([2], 6),
                                                  _rep([0, 1], 20)]))]
    if case == "equal_lanes":       # one read twice in the window: equal
        seg = rng.integers(0, 4, 24).astype(np.int8)   # maxima in a row
        return [(seg, np.concatenate([seg, rng.integers(0, 4, gap).astype(
            np.int8), seg])) for gap in (4, 8, 20, 40, 100, 180)]
    if case == "short_windows":     # dead on both sides of the first rows
        read = rng.integers(0, 4, 120).astype(np.int8)
        return [(read, read[:n].copy()) for n in (1, 2, 5, 30, 63, 64, 65,
                                                  100, 127)]
    if case == "long_indels":       # F and E chains across many lanes
        x = rng.integers(0, 4, 160).astype(np.int8)
        return [(np.concatenate([x[:40], x[40 + g:140]]), x) for g in
                (1, 3, 4, 5, 9, 17, 33, 60)] \
            + [(np.concatenate([x[:40], rng.integers(0, 4, g).astype(
                np.int8), x[40:100]]), x[:110]) for g in (1, 4, 7, 18, 40)]
    if case == "all_n":
        t = rng.integers(0, 4, 150).astype(np.int8)
        return [(np.full(100, 4, np.int8), t), (t[:100].copy(),
                                                np.full(150, 4, np.int8)),
                (np.full(80, 4, np.int8), np.full(90, 4, np.int8))]
    if case == "all_zero":          # every live H is 0
        return [(_rep([0], 100), _rep([1], 120)),
                (_rep([2, 3], 70), _rep([0, 1], 50)),
                (_rep([1], 3), _rep([2], 200))]
    return _tie_pairs(case, rng)


PACKED_CASES = DP_CASES + ["later_row_equal", "equal_lanes", "short_windows",
                           "long_indels", "all_n", "all_zero"]


def _sw_scores_packed_rows(ra, rl, ta, tl, *, band, match, mismatch,
                           gap_open, gap_extend):
    """The score-only DP as the warp form's packed rows compute it, on the
    caller's windows (reads (N, q_max) and refs (N, t_max) of codes 0..4,
    their lengths): slot k of lane k // S, S = band / 32. Returns (3, N).

    A row looks its substitution up in a table of bytes built from the read
    code, four slots a word through their reference codes, and extracts
    each slot's signed byte. No cell is tested for being dead: the cells
    left of the window (sub 0) compute H = E = 0 themselves, those right of
    it feed only each other and never win. E is kept as E - gap_extend. g
    and F are taken in the lane's frame (k0 * gap_extend left out), the
    lane's running maximum p of g and A = max(p + d, Hnod, 0) in one walk,
    the scan over the lanes moves each total into the receiving lane's
    frame, then H = max(y + d, A). The best: key 16 * H + 15 - j, the row's
    largest key replaces the lane's best when its H part is larger. Values
    are int64 here; none leaves int32's range."""
    i64 = np.int64
    n, q_max = ra.shape
    slots = band // 32
    half = band // 2
    go, ge = gap_open, gap_extend
    for p in range(n):   # the kernel walks exact rows for any other pair
        assert np.isin(ta[p, :tl[p]], np.arange(5)).all()
    rlen = np.clip(rl, 0, (q_max + 127) // 128 * 128).astype(i64)
    tlen = np.clip(tl, 0, ta.shape[1]).astype(i64)
    j = np.arange(slots, dtype=i64)
    c = j * ge - go
    d = (1 - j) * ge
    k = np.arange(band, dtype=i64)
    xw = (-mismatch) & 0xFF
    h = np.zeros((n, 32, slots), i64)
    ee = np.full((n, 32, slots), -ge, i64)
    best = np.full((n, 32), 15, i64)
    best_i = np.zeros((n, 32), i64)
    rows = np.arange(n)
    for i in range(int(rlen.max(initial=0))):
        active = i < rlen
        rc = ra[:, i].astype(i64) & 0xFF if i < q_max else np.full(n, 4, i64)
        # the table: bytes 0..3 for the codes 0..3, zero for 4..7
        tab = np.zeros((n, 8), i64)
        base = rc < 4
        tab[:, :4] = np.where((rc == 4)[:, None], 0, xw)
        tab[rows[base], rc[base]] = match & 0xFF
        pos = i + k - half
        inside = (pos >= 0) & (pos < tlen[:, None])
        code = np.where(inside, ta[rows[:, None], np.clip(pos, 0, ta.shape[1]
                                                           - 1)], 5)
        looked_up = tab[rows[:, None], code]
        words = (looked_up.reshape(n, band // 4, 4)
                 << (8 * np.arange(4, dtype=i64))).sum(axis=2)
        sub = ((words[:, :, None] >> (8 * np.arange(4, dtype=i64))) & 0xFF)
        sub = np.where(sub >= 128, sub - 256, sub).reshape(n, 32, slots)

        flat_h, flat_e = h.reshape(n, band), ee.reshape(n, band)
        up_h = np.concatenate([flat_h[:, 1:], np.full((n, 1), NEG)], axis=1)
        up_e = np.concatenate([flat_e[:, 1:], np.full((n, 1), NEG)], axis=1)
        e_new = np.maximum(up_h - go, up_e).reshape(n, 32, slots)
        h_nod = np.maximum(h + sub, e_new)
        ee_new = np.maximum(e_new - ge, -ge)
        a = np.empty_like(h)
        p = np.full((n, 32), NEG, i64)
        for s in range(slots):
            a[:, :, s] = np.maximum(np.maximum(p + d[s], h_nod[:, :, s]), 0)
            p = np.maximum(h_nod[:, :, s] + c[s], p)
        t = p
        s = 1
        while s < 32:
            moved = np.concatenate([t[:, :s], t[:, :-s]], axis=1)
            t = np.maximum(moved - slots * s * ge, t)
            s *= 2
        y = np.concatenate([np.full((n, 1), NEG), t[:, :-1] - slots * ge],
                           axis=1)
        h_new = np.maximum(y[:, :, None] + d, a)
        m = (16 * h_new + 15 - j).max(axis=2)
        take = active[:, None] & (m > (best | 15))
        best = np.where(take, m, best)
        best_i = np.where(take, i, best_i)
        h = np.where(active[:, None, None], h_new, h)
        ee = np.where(active[:, None, None], ee_new, ee)

    v = best >> 4
    kk = np.arange(32, dtype=i64) * slots + 15 - (best & 15)
    out = np.zeros((3, n), i64)
    for p in range(n):
        top = v[p].max()
        at = np.flatnonzero(v[p] == top)
        row = best_i[p, at].min()
        slot = kk[p, at[best_i[p, at] == row]].min()
        out[:, p] = (top, row, row + slot - half) if top > 0 \
            else (0, 0, -half)
    return out.astype(np.int32)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", PACKED_CASES)
def test_sw_scores_packed_rows_equal_reference(case, slots):
    band = 32 * slots
    rng = np.random.default_rng(600 * slots + PACKED_CASES.index(case))
    arrays = _batch(_packed_row_pairs(case, rng))
    got = _sw_scores_packed_rows(*arrays, band=band, **PARAMS)
    prepared = sw._prepare(*(torch.from_numpy(x) for x in arrays), band)
    ref = sw.banded_sw_scores_torch(*prepared, band=band, **PARAMS)
    np.testing.assert_array_equal(got, ref.numpy())
    jax_ref = np.stack([np.asarray(x) for x in jax_sw_scores(
        *arrays, band=band, batch_tile=8, backend="jnp", **PARAMS)])
    np.testing.assert_array_equal(got, jax_ref)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("params", [
    dict(match=4, mismatch=6, gap_open=8, gap_extend=2),
    dict(match=1, mismatch=1, gap_open=1, gap_extend=1),
    dict(match=3, mismatch=5, gap_open=0, gap_extend=0)],
    ids=["4-6-8-2", "1-1-1-1", "3-5-0-0"])
def test_sw_scores_packed_rows_other_scoring(params, slots):
    """Other scorings the packed rows take: the native realignment's, ties
    among diagonal, E and F, and gap penalties of 0 (a dead cell's F then
    reaches the live cells at 0 itself)."""
    band = 32 * slots
    rng = np.random.default_rng(700 + slots)
    pairs = []
    for case in PACKED_CASES:
        pairs += _packed_row_pairs(case, rng)
    arrays = _batch(pairs)
    got = _sw_scores_packed_rows(*arrays, band=band, **params)
    prepared = sw._prepare(*(torch.from_numpy(x) for x in arrays), band)
    ref = sw.banded_sw_scores_torch(*prepared, band=band, **params)
    np.testing.assert_array_equal(got, ref.numpy())

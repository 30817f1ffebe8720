"""Port parity for the helpers no map path calls, against the TPU package
(exact equality: every output is an integer): align/chain.py's
chain_scores, chain_extents, backtrack_chain and chain_scores_reference on
tests/test_chain.py's cases; align/device_seed.py's sketch_device and
_blocked_cummax; align/pipeline.py's _cigar_stats."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapath_nano_tpu.align import chain as jchain
from megapath_nano_tpu.align import device_seed as jseed
from megapath_nano_tpu.align import pipeline as jpipe
from megapath_nano_tpu_torch.align import chain as tchain
from megapath_nano_tpu_torch.align import device_seed as tseed
from megapath_nano_tpu_torch.align import pipeline as tpipe


def _batch(qs, ts):
    n, a = len(qs), max(len(q) for q in qs)
    q_arr = np.zeros((n, a), np.int32)
    t_arr = np.zeros((n, a), np.int32)
    cnt = np.zeros(n, np.int32)
    for i, (q, t) in enumerate(zip(qs, ts)):
        q_arr[i, : len(q)] = q
        t_arr[i, : len(t)] = t
        cnt[i] = len(q)
    return q_arr, t_arr, cnt


def _colinear(seed=5, rows=8):
    """test_chain.test_matches_scalar_reference's rows: colinear anchors
    with jitter."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(rows):
        n_anchor = int(rng.integers(5, 60))
        base_q = np.sort(rng.integers(0, 2000, n_anchor))
        t0 = int(rng.integers(0, 10000))
        base_t = base_q + t0 + rng.integers(-20, 20, n_anchor)
        order = np.argsort(base_t, kind="stable")
        qs.append(base_q[order].astype(np.int32))
        ts.append(base_t[order].astype(np.int32))
    return qs, ts


def _perfect():
    """test_chain.test_perfect_colinear_chain: a 1000 bp match."""
    q = np.arange(15, 1000, 20, dtype=np.int32)
    return [q], [q + 5000]


def _noise():
    """test_chain.test_noise_anchors_not_chained: random diagonals."""
    rng = np.random.default_rng(1)
    q = np.sort(rng.integers(0, 1000, 30)).astype(np.int32)
    t = rng.integers(0, 100000, 30).astype(np.int32)
    order = np.argsort(t, kind="stable")
    return [q[order]], [t[order]]


def _mixed():
    """The three above in one batch, with a row of one anchor and a row cut
    to 0 anchors (its planes hold data past the count)."""
    qs, ts = _colinear(seed=9, rows=5)
    for more in (_perfect(), _noise()):
        qs += more[0]
        ts += more[1]
    qs.append(np.array([40], np.int32))
    ts.append(np.array([900], np.int32))
    return qs, ts


CASES = {"colinear": _colinear, "perfect": _perfect, "noise": _noise,
         "mixed": _mixed}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("min_score", [0, 60])
def test_chain_scores_matches_jax(case, min_score):
    q, t, cnt = _batch(*CASES[case]())
    if case == "mixed":
        cnt[-2] = 0
    ref = [np.asarray(x) for x in jchain.chain_scores(
        q, t, cnt, min_score=min_score)]
    got = [x.numpy() for x in tchain.chain_scores(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(cnt),
        min_score=min_score)]
    for name, a, b in zip(("f", "parent", "best_score", "best_idx"), got,
                          ref):
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_scores_match_scalar_reference(case):
    qs, ts = CASES[case]()
    q, t, cnt = _batch(qs, ts)
    f, parent, _, _ = tchain.chain_scores(torch.from_numpy(q),
                                          torch.from_numpy(t),
                                          torch.from_numpy(cnt))
    for i, (qi, ti) in enumerate(zip(qs, ts)):
        f_ref, p_ref = tchain.chain_scores_reference(qi, ti)
        j_ref, jp_ref = jchain.chain_scores_reference(qi, ti)
        np.testing.assert_array_equal(f_ref, j_ref)
        np.testing.assert_array_equal(p_ref, jp_ref)
        assert f[i, : len(qi)].tolist() == f_ref.tolist(), f"row {i} f"
        assert parent[i, : len(qi)].tolist() == p_ref.tolist(), i


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_extents_and_backtrack_match_jax(case):
    q, t, cnt = _batch(*CASES[case]())
    f, parent, best, best_idx = jchain.chain_scores(q, t, cnt)
    ref = [np.asarray(x) for x in jchain.chain_extents(
        jnp.asarray(q), jnp.asarray(t), parent, best_idx)]
    got = [x.numpy() for x in tchain.chain_extents(
        torch.from_numpy(q), torch.from_numpy(t),
        torch.from_numpy(np.array(parent)),
        torch.from_numpy(np.array(best_idx)))]
    for name, a, b in zip(("q_min", "q_max", "t_min", "t_max", "length"),
                          got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    parent, best_idx = np.asarray(parent), np.asarray(best_idx)
    for i in range(len(cnt)):
        chain = tchain.backtrack_chain(parent[i], int(best_idx[i]))
        np.testing.assert_array_equal(
            chain, jchain.backtrack_chain(parent[i], int(best_idx[i])))
        assert len(chain) == got[4][i]
    if case == "perfect":
        assert len(chain) == q.shape[1]      # every anchor chained


def _codes(seed, n=6, L=512, with_n=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.int8)
    if with_n:
        codes[rng.random((n, L)) < 0.01] = 4
    codes[1, 100:140] = 2                    # a homopolymer run (ties)
    qlens = rng.integers(L // 2, L + 1, n).astype(np.int32)
    qlens[0] = L
    qlens[-1] = 10                           # shorter than a k-mer
    return codes, qlens


@pytest.mark.parametrize("k,w", [(15, 10), (11, 5), (7, 3), (5, 1)])
def test_sketch_device_matches_jax(k, w):
    codes, qlens = _codes(seed=k * 10 + w)
    win, H, strand = (np.asarray(x) for x in jseed.sketch_device(
        jnp.asarray(codes), jnp.asarray(qlens), k=k, w=w))
    twin, tH, tstrand = (x.numpy() for x in tseed.sketch_device(
        torch.from_numpy(codes), torch.from_numpy(qlens), k=k, w=w))
    assert win.sum() > 0
    np.testing.assert_array_equal(twin, win)
    np.testing.assert_array_equal(tH, H.astype(np.int64))
    np.testing.assert_array_equal(tstrand, strand)


@pytest.mark.parametrize("n,block", [(4096, 256), (1000, 256), (512, 64),
                                     (256, 256)])
def test_blocked_cummax_matches_jax(n, block):
    rng = np.random.default_rng(n)
    x = rng.integers(-(2 ** 31) + 1, 2 ** 31 - 1, n).astype(np.int32)
    x[rng.random(n) < 0.5] = -(2 ** 31) + 1
    # jitted: eager JAX compiles every op of the scan on its own
    ref = np.asarray(jax.jit(functools.partial(
        jseed._blocked_cummax, block=block))(jnp.asarray(x)))
    got = tseed._blocked_cummax(torch.from_numpy(x), block=block).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))


def test_cigar_stats_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        ops = [(int(rng.integers(1, 30)), str(rng.choice(list("MID"))))
               for _ in range(int(rng.integers(1, 12)))]
        q_len = sum(n for n, op in ops if op in "MI") + 5
        t_len = sum(n for n, op in ops if op in "MD") + 7
        read = rng.integers(0, 4, q_len).astype(np.int8)
        ref = rng.integers(0, 4, t_len).astype(np.int8)
        ref[: min(q_len, t_len)] = np.where(
            rng.random(min(q_len, t_len)) < 0.8,
            read[: min(q_len, t_len)], ref[: min(q_len, t_len)])
        args = (ops, read, ref, int(rng.integers(0, 5)),
                int(rng.integers(0, 7)))
        assert tpipe._cigar_stats(*args) == jpipe._cigar_stats(*args)

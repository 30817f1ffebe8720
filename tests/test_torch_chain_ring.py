"""The chain kernel's order of operations, on the CPU.

`csrc/chain.cu` keeps the window of 32 predecessors as a ring over a warp's
lanes, forms a step's gap terms one step ahead, picks the best predecessor
from a rotated ballot, stops at the group's own count and carries the best
anchor along. `kernels/chain.py chain_and_extents_ring` is that order in
plain PyTorch. Here it is held, with exact equality, to the plain version
`chain_and_extents_torch` (a sliding window, with which it shares no code)
and to the TPU package's `align/chain.py chain_and_extents`."""

import sys
import threading

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align.chain import chain_and_extents as jax_chain
from megapath_nano_tpu_torch.kernels.chain import (
    beta_tensor, chain_and_extents_ring, chain_and_extents_torch)
from test_torch_chain import _groups

K, MAX_DIST, BANDWIDTH = 15, 5000, 500


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hold(q, t, cnt, window=32):
    """ring == plain == JAX on these rows; returns the (6, N) result."""
    kw = dict(window=window, k=K, max_dist=MAX_DIST, bandwidth=BANDWIDTH)
    args = [torch.from_numpy(x) for x in (q, t, cnt)]
    beta = beta_tensor(K, BANDWIDTH, "cpu")
    ring = chain_and_extents_ring(*args, beta, **kw)
    plain = chain_and_extents_torch(*args, beta, **kw)
    assert ring.dtype == torch.int32 and ring.shape == (6, len(cnt))
    np.testing.assert_array_equal(ring.numpy(), plain.numpy())
    np.testing.assert_array_equal(ring.numpy(),
                                  np.asarray(jax_chain(q, t, cnt, **kw)))
    return ring.numpy()


def _counts(rng, n, a):
    """Counts over the whole range, the edges first: 0, 1, a, above a and
    negative (both clamped)."""
    cnt = rng.integers(0, a + 1, n).astype(np.int32)
    cnt[:6] = [0, 1, a, a + 3, -2, a]
    return cnt


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("a", [1, 31, 32, 33, 100, 256])
def test_ring_row_kinds(a, dtype):
    """Colinear, noisy and random rows (a third each) at anchor counts
    below, at and beyond the ring's 32 lanes."""
    rng = np.random.default_rng(a)
    n = 24 if a <= 100 else 12
    q, t, _ = _groups(rng, n, a)
    got = _hold(q.astype(dtype), t.astype(dtype), _counts(rng, n, a))
    if a >= 31:
        assert (got[5] > 3).sum() >= 3          # real chains were formed
    assert got[:, 0].tolist() == [0, q[0, 0], q[0, 0], t[0, 0], t[0, 0], 1]


@pytest.mark.parametrize("window", [1, 7, 31, 32])
@pytest.mark.parametrize("a", [33, 100])
def test_ring_windows(a, window):
    rng = np.random.default_rng(100 * window + a)
    q, t, _ = _groups(rng, 18, a)
    _hold(q, t, _counts(rng, 18, a), window=window)


@pytest.mark.parametrize("count", ["zero", "one", "full", "above", "negative"])
def test_ring_uniform_counts(count):
    """A whole batch at one edge count: the loop runs 0, 1 or a steps for
    every group."""
    a = 40
    rng = np.random.default_rng(7)
    q, t, _ = _groups(rng, 9, a)
    value = {"zero": 0, "one": 1, "full": a, "above": a + 9,
             "negative": -5}[count]
    got = _hold(q, t, np.full(9, value, np.int32))
    if value <= 0:
        np.testing.assert_array_equal(
            got, np.stack([np.zeros(9, np.int32), q[:, 0], q[:, 0], t[:, 0],
                           t[:, 0], np.ones(9, np.int32)]))


def _tied_predecessors(fill, a):
    """A row whose last anchor has two predecessors with the same candidate
    score: `fill` anchors that chain with nothing (equal q), then j1 =
    (100, 100) and j2 = (90, 110), which exclude each other, then (200, 210):
    |dq - dt| = 10 and alpha = k from both. The older, j1, must win, so the
    chain starts at (100, 100). With fill >= 31 the two sit on either side
    of the ring's wrap, j2 in a lower lane than j1."""
    far = 20000
    q = np.zeros(a, np.int32)
    t = np.zeros(a, np.int32)
    t[:fill] = 1 + np.arange(fill)
    q[fill: fill + 3] = far + np.array([100, 90, 200])
    t[fill: fill + 3] = far + np.array([100, 110, 210])
    return q, t, fill + 3, far


@pytest.mark.parametrize("fill", [0, 5, 29, 30, 31, 32, 33, 62, 63, 64, 95])
def test_ring_oldest_predecessor_wins_ties(fill):
    q, t, cnt, far = _tied_predecessors(fill, 100)
    got = _hold(q[None], t[None], np.array([cnt], np.int32))
    beta10 = int(beta_tensor(K, BANDWIDTH, "cpu")[10])
    assert got[:, 0].tolist() == [2 * K - beta10, far + 100, far + 200,
                                  far + 100, far + 210, 2]


@pytest.mark.parametrize("gap", [1, 30, 31, 32, 33, 70])
def test_ring_first_best_anchor_wins_ties(gap):
    """Two chains of two anchors with the same score, `gap` lone anchors
    between them: the first chain is reported."""
    a = 80
    far = 15000
    q = np.zeros(a, np.int32)
    t = np.zeros(a, np.int32)
    q[:2], t[:2] = [50, 150], [60, 160]
    t[2: 2 + gap] = far + np.arange(gap)
    q[2 + gap: 4 + gap] = [2 * far + 300, 2 * far + 400]
    t[2 + gap: 4 + gap] = [2 * far + 300, 2 * far + 400]
    got = _hold(q[None], t[None], np.array([4 + gap], np.int32))
    assert got[:, 0].tolist() == [2 * K, 50, 150, 60, 160, 2]


def test_beta_tensor_one_per_device_under_threads():
    """Many threads ask for a table nobody has asked for yet: one upload,
    one tensor, the table's values."""
    from megapath_nano_tpu_torch.kernels import chain

    k, bandwidth = 13, 217
    assert (k, bandwidth, torch.device("cpu")) not in chain._beta_tensors
    got = []
    gate = threading.Barrier(16)

    def work():
        gate.wait(timeout=60)
        for _ in range(200):
            got.append(chain.beta_tensor(k, bandwidth, "cpu"))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads)
    assert len(got) == 16 * 200 and len({id(x) for x in got}) == 1
    assert [key for key in chain._beta_tensors
            if key[:2] == (k, bandwidth)] == [(k, bandwidth,
                                               torch.device("cpu"))]
    np.testing.assert_array_equal(got[0].numpy(),
                                  chain.beta_table(k, bandwidth))

"""Port parity: the score-only banded extension (megapath_nano_tpu_torch
kernels/sw.py banded_sw_scores, plain version on the CPU) against the TPU
package's banded_sw_scores with backend="jnp", and against its scalar numpy
reference. Every output is an integer, so the tolerance is exact equality of
(score, end_read, end_ref)."""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.kernels.sw import banded_sw_reference
from megapath_nano_tpu.kernels.sw import banded_sw_scores as jax_sw_scores
from megapath_nano_tpu.utils.dna import mutate, random_sequence
from megapath_nano_tpu_torch.kernels import sw
from megapath_nano_tpu_torch.kernels.sw import banded_sw_scores

PARAMS = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(pairs, q_max=None, t_max=None):
    n = len(pairs)
    q_max = q_max or max(len(r) for r, _ in pairs)
    t_max = t_max or max(len(t) for _, t in pairs)
    ra = np.full((n, q_max), 4, np.int8)
    ta = np.full((n, t_max), 5, np.int8)
    rl = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    for i, (r, t) in enumerate(pairs):
        ra[i, : len(r)] = r
        ta[i, : len(t)] = t
        rl[i] = len(r)
        tl[i] = len(t)
    return ra, rl, ta, tl


def _both(ra, rl, ta, tl, band):
    ref = np.stack([np.asarray(x) for x in jax_sw_scores(
        ra, rl, ta, tl, band=band, batch_tile=8, backend="jnp", **PARAMS)])
    before = banded_sw_scores.launches
    got = banded_sw_scores(*(torch.from_numpy(x) for x in (ra, rl, ta, tl)),
                           band=band, **PARAMS)
    assert banded_sw_scores.launches == before   # CPU tensors: plain version
    assert all(g.dtype == torch.int32 and g.shape == (len(ra),) for g in got)
    return ref, np.stack([g.numpy() for g in got])


@pytest.mark.parametrize("band", [128, 256, 512])
@pytest.mark.parametrize("err", [0.0, 0.08, 0.2])
def test_random_pairs_equal_jax(band, err):
    rng = np.random.default_rng(1000 * band + int(100 * err))
    pairs = []
    for _ in range(10):
        t = random_sequence(rng, int(rng.integers(250, 420)))
        s = int(rng.integers(0, 40))
        r = mutate(rng, t[s: s + int(rng.integers(150, 330))],
                   sub_rate=err / 2, ins_rate=err / 4, del_rate=err / 4)
        pairs.append((r, t))
    ref, got = _both(*_batch(pairs), band)
    np.testing.assert_array_equal(got, ref)
    assert (got[0] > 0).all()


def _edge_pairs():
    rng = np.random.default_rng(77)
    t = random_sequence(rng, 300)
    # read runs past the end of its ref window, with a deletion (gap in the
    # read, E chain) open right at the ref's last bases: the E values next
    # to and on the dead (sentinel) slots are carried across rows
    edge_gap = np.concatenate([t[40:180], t[186:200], random_sequence(rng, 90)])
    return {
        "identical": (t[:260].copy(), t),
        "empty_read": (np.zeros(0, np.int8), t),
        "empty_ref": (t[:100].copy(), np.zeros(0, np.int8)),
        "all_n_read": (np.full(120, 4, np.int8), t[:200]),
        "all_n_ref": (t[:80].copy(), np.full(150, 4, np.int8)),
        "ref_shorter_than_read": (random_sequence(rng, 280), t[:70]),
        "no_positive_cell": (np.zeros(90, np.int8), np.ones(110, np.int8)),
        "dead_slot_gap_at_edge": (edge_gap, t[:200]),
        "read_longer_than_band_past_ref": (t[:290].copy(), t[:100]),
    }


@pytest.mark.parametrize("case", sorted(_edge_pairs()))
def test_edge_case_equal_jax(case):
    r, t = _edge_pairs()[case]
    # N = 3 rows (not a multiple of any tile), the case in the middle
    filler = _edge_pairs()["identical"]
    ref, got = _both(*_batch([filler, (r, t), filler], q_max=300, t_max=300),
                     128)
    np.testing.assert_array_equal(got, ref)
    if case in ("empty_read", "empty_ref", "all_n_read", "all_n_ref",
                "no_positive_cell"):
        assert got[:, 1].tolist() == [0, 0, -64]
    exp = banded_sw_reference(r, t, band=128, **PARAMS) \
        if len(r) and len(t) else None
    if exp is not None and exp[0] > 0:
        assert tuple(int(x) for x in got[:, 1]) == exp


def test_matches_scalar_band_reference():
    # the world of the TPU package's test_kernel_matches_scalar_band_reference
    rng = np.random.default_rng(42)
    pairs = []
    for _ in range(16):
        ref = random_sequence(rng, 400)
        start = int(rng.integers(0, 180))
        read = mutate(rng, ref[start: start + 200], sub_rate=0.08,
                      ins_rate=0.04, del_rate=0.04)
        pairs.append((read, ref))
    got = banded_sw_scores(*(torch.from_numpy(x) for x in
                             _batch(pairs, 256, 512)), band=128, **PARAMS)
    got = np.stack([g.numpy() for g in got])
    for i, (read, ref) in enumerate(pairs):
        assert tuple(int(x) for x in got[:, i]) == banded_sw_reference(
            read, ref, band=128, **PARAMS), f"case {i}"


def test_all_rows_empty_and_odd_shapes():
    # every read empty: the plain version writes the constant column
    ra, rl, ta, tl = _batch([(np.zeros(0, np.int8), np.ones(50, np.int8))] * 5,
                            q_max=130, t_max=77)
    ref, got = _both(ra, rl, ta, tl, 128)
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [[0] * 5, [0] * 5, [-64] * 5]


def test_wrapper_rejects_mixed_devices_and_bad_band():
    ra, rl, ta, tl = (torch.from_numpy(x) for x in _batch(
        [(np.zeros(10, np.int8), np.zeros(20, np.int8))]))
    with pytest.raises(ValueError, match="band"):
        banded_sw_scores(ra, rl, ta, tl, band=100)
    with pytest.raises(ValueError, match="reads on"):
        banded_sw_scores(ra, rl.to("meta"), ta, tl)
    # no 2**15 window limit here, unlike the full-stats wrapper
    big = torch.full((1, 2 ** 15), 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="32k"):
        sw.banded_sw_full(big, rl, ta, tl)
    s, ei, ej = banded_sw_scores(big, torch.zeros(1, dtype=torch.int32), ta,
                                 tl)
    assert (int(s), int(ei), int(ej)) == (0, 0, -64)

"""Port parity at bands above 1024: the plain versions of both banded
extensions (megapath_nano_tpu_torch kernels/sw.py, on the CPU) against the
TPU package's banded_sw_full and banded_sw_scores with backend="jnp", at
bands 1152 and 2048, which the reference takes like every multiple of 128.
Every output is an integer, so the tolerance is exact equality. The
full-stats wrapper refuses windows past its 2**15 packing, as the reference
does. (The CUDA block-per-pair kernels at these bands are held to the plain
versions on the card: tests/test_torch_cuda.py, chip_smoke.py.)"""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.kernels.sw import banded_sw_full as jax_sw_full
from megapath_nano_tpu.kernels.sw import banded_sw_scores as jax_sw_scores
from megapath_nano_tpu.utils.dna import mutate, random_sequence
from megapath_nano_tpu_torch.kernels.sw import (banded_sw_full,
                                                banded_sw_scores)

PARAMS = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the whole module, its module-scoped fixtures
    included (xdist runs several files at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(pairs):
    n = len(pairs)
    ra = np.full((n, max(len(r) for r, _ in pairs)), 4, np.int8)
    ta = np.full((n, max(len(t) for _, t in pairs)), 5, np.int8)
    for i, (r, t) in enumerate(pairs):
        ra[i, : len(r)] = r
        ta[i, : len(t)] = t
    return (ra, np.array([len(r) for r, _ in pairs], np.int32), ta,
            np.array([len(t) for _, t in pairs], np.int32))


def _pairs(seed, band):
    """8 pairs, reads of at most 1 kb: reads that sit far off the window's
    main diagonal (up to most of half a band), a long deletion and a long
    insertion (the F and E chains across many slots), a read longer than
    its ref, an empty read and an unrelated one."""
    rng = np.random.default_rng(seed)
    half = band // 2
    pairs = []
    for off in (0, half // 3, half - 150):
        t = random_sequence(rng, off + 650)
        r = mutate(rng, t[off: off + 600], sub_rate=0.03, ins_rate=0.015,
                   del_rate=0.015)
        pairs.append((r, t))
    t = random_sequence(rng, 1000)
    pairs.append((np.concatenate([t[:300], t[700:950]]), t))    # 400 b gap
    r = t[100:500]
    pairs.append((np.concatenate([r[:200], random_sequence(rng, 300),
                                  r[200:]]), t))                # insertion
    pairs.append((mutate(rng, t, sub_rate=0.05), t[:700]))
    pairs.append((np.zeros(0, np.int8), t))
    pairs.append((random_sequence(rng, 800), random_sequence(rng, 900)))
    return pairs


@pytest.mark.parametrize("band", [1152, 2048])
def test_wide_band_plain_versions_bit_equal(band):
    ra, rl, ta, tl = _batch(_pairs(band, band))
    args = [torch.from_numpy(x) for x in (ra, rl, ta, tl)]

    ref = np.asarray(jax_sw_full(ra, rl, ta, tl, band=band, batch_tile=8,
                                 backend="jnp", **PARAMS))
    got = banded_sw_full(*args, band=band, **PARAMS)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the offset reads align near their full length, off the main diagonal
    assert (ref[:3, 0] > 600).all() and ref[2, 6] - ref[2, 5] > 0

    ref = np.stack([np.asarray(x) for x in jax_sw_scores(
        ra, rl, ta, tl, band=band, batch_tile=8, backend="jnp", **PARAMS)])
    got = torch.stack(banded_sw_scores(*args, band=band, **PARAMS))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_full_stats_window_limit_as_the_reference():
    """q_max + band >= 2**15 is refused by both packages (the begin/end
    packing of the full-stats DP); one column less is taken."""
    band = 2048
    q = 2 ** 15 - band
    ra = np.full((1, q), 4, np.int8)
    ta = np.full((1, 256), 5, np.int8)
    lens = np.zeros(1, np.int32)
    with pytest.raises(AssertionError, match="windows < 32k"):
        jax_sw_full(ra, lens, ta, lens, band=band, backend="jnp", **PARAMS)
    args = [torch.from_numpy(x) for x in (ra, lens, ta, lens)]
    with pytest.raises(ValueError, match="windows < 32k"):
        banded_sw_full(*args, band=band, **PARAMS)
    args[0] = args[0][:, : q - 128]
    got = banded_sw_full(*args, band=band, **PARAMS)
    assert got.tolist() == [[0, 0, -band // 2, 0, 0, -band, -band]]


@pytest.mark.parametrize("band", [0, 64, 1000, -128])
def test_band_must_be_a_positive_multiple_of_128(band):
    args = [torch.from_numpy(x) for x in _batch(_pairs(0, 1152)[:2])]
    for fn in (banded_sw_full, banded_sw_scores):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(*args, band=band, **PARAMS)

"""The port's CUDA kernels against their plain PyTorch versions on the card
(bit-equal: every output is an integer). Marked `cuda`: without a CUDA
device these skip. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -n 0
"""

import numpy as np
import pytest
import torch

from megapath_nano_tpu_torch.kernels import chain, sw

pytestmark = pytest.mark.cuda
PARAMS = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("band", [128, 256, 512])
def test_sw_full_kernel_matches_plain(cuda, band):
    rng = np.random.default_rng(band)
    n, q, t = 64, 700, 900
    ta = rng.integers(0, 4, (n, t)).astype(np.int8)
    ra = ta[:, 10: 10 + q].copy()
    flip = rng.random((n, q)) < 0.06
    ra[flip] = rng.integers(0, 5, int(flip.sum()))
    rl = rng.integers(0, q + 1, n).astype(np.int32)
    tl = rng.integers(0, t + 1, n).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (ra, rl, ta, tl)]
    before = sw.banded_sw_full.launches
    got = sw.banded_sw_full(*args, band=band, **PARAMS)
    assert sw.banded_sw_full.launches == before + 1
    ref = sw.banded_sw_full_torch(*sw._prepare(*args, band), band=band,
                                  **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.parametrize("band", [128, 256, 512])
def test_sw_scores_kernel_matches_plain(cuda, band):
    rng = np.random.default_rng(band + 1)
    n, q, t = 67, 700, 900
    ta = rng.integers(0, 4, (n, t)).astype(np.int8)
    ra = ta[:, 10: 10 + q].copy()
    flip = rng.random((n, q)) < 0.06
    ra[flip] = rng.integers(0, 5, int(flip.sum()))
    rl = rng.integers(0, q + 1, n).astype(np.int32)
    tl = rng.integers(0, t + 1, n).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (ra, rl, ta, tl)]
    before = sw.banded_sw_scores.launches
    got = torch.stack(sw.banded_sw_scores(*args, band=band, **PARAMS))
    assert sw.banded_sw_scores.launches == before + 1
    ref = sw.banded_sw_scores_torch(*sw._prepare(*args, band), band=band,
                                    **PARAMS)
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.parametrize("a", [32, 256])
def test_chain_kernel_matches_plain(cuda, a):
    rng = np.random.default_rng(a)
    n = 2000
    t = np.sort(rng.integers(0, 3000 * a // 32, (n, a)), axis=1).astype(
        np.int32)
    q = (t + rng.integers(-30, 30, (n, a))).clip(0).astype(np.int32)
    cnt = rng.integers(0, a + 1, n).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, cnt)]
    before = chain.chain_and_extents.launches
    got = chain.chain_and_extents(*args)
    assert chain.chain_and_extents.launches == before + 1
    beta = torch.from_numpy(chain.beta_table(15, 500).copy()).to(cuda)
    ref = chain.chain_and_extents_torch(*args, beta, window=32, k=15,
                                        max_dist=5000, bandwidth=500)
    assert torch.equal(got.cpu(), ref.cpu())

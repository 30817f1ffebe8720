"""Port parity for the variant model: the port's ClairNet / VariantModel
(device "cpu") against the TPU package's flax model on the CPU.

- Inference: each shipped pickle through both packages on 256 seeded
  tensors: every probability within 5e-6 (measured: 8.3e-7 on
  model-000), every argmax equal.
- Weights: the state functions carry a model both ways, and each
  package's pickle loads in the other with the same predictions.
- Training: from the TPU package's init carried across (hidden 32, the
  planted-signal world of tests/test_variant.py), the loss of steps 0-4
  within 1e-4 relative and the loss after 30 steps within 1e-2 (measured:
  below 2e-6 for both); bias_hh stays 0 and out of the optimizer.
"""

import os

import jax
import numpy as np
import pytest
import torch

from megapath_nano_tpu.variant import model as jmodel
from megapath_nano_tpu.variant.candidates import CHANNELS, POSITIONS, ROWS
from megapath_nano_tpu.variant.pretrained import default_model_dir
from megapath_nano_tpu_torch import state
from megapath_nano_tpu_torch.variant import model as tmodel
from megapath_nano_tpu_torch.variant import pretrained as tpretrained

SHIPPED = ["model-000.pkl", "model-001.pkl", "model-002.pkl"]
PROB_TOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seeded_tensors(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return rng.random((n, POSITIONS, ROWS, CHANNELS)).astype(np.float32)


def assert_probs_close(got, ref, tol=PROB_TOL):
    assert set(got) == set(ref) == set(tmodel.TASKS)
    worst = 0.0
    for task in ref:
        assert got[task].shape == ref[task].shape
        worst = max(worst, float(np.abs(got[task] - ref[task]).max()))
        assert np.array_equal(got[task].argmax(1), ref[task].argmax(1)), task
    assert worst <= tol, worst
    return worst


def planted_world(seed, n=64):
    """tests/test_variant.py's synthetic separation world: zygosity planted
    in row 7 of the centre, gt21 in the first cell."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, POSITIONS, ROWS, CHANNELS)).astype(np.float32) * 0.1
    zyg = rng.integers(0, 3, n)
    x[np.arange(n), POSITIONS // 2, 7, 0] = np.array([0.02, 0.5, 0.95])[zyg]
    labels = {"gt21": rng.integers(0, 10, n), "zygosity": zyg,
              "var_len_1": np.zeros(n, np.int64),
              "var_len_2": np.zeros(n, np.int64)}
    x[:, 0, 0, 0] = labels["gt21"] / 10.0
    return x, labels


@pytest.mark.parametrize("name", SHIPPED)
def test_clairnet_matches_jax_on_shipped_models(name):
    path = os.path.join(default_model_dir(), name)
    j = jmodel.VariantModel(hidden=96)
    j.load(path)
    t = tmodel.VariantModel(hidden=96, device="cpu")
    t.load(path)
    x = seeded_tensors()
    assert_probs_close(t.predict(x), j.predict(x))


def test_port_reads_the_shipped_ensemble():
    models = tpretrained.default_ensemble("cpu")
    assert len(models) == 3
    assert all(m.net.hidden == 96 and m.device.type == "cpu"
               for m in models)
    assert tpretrained.manifest()["models"] == SHIPPED


def test_jax_pickle_through_the_port_and_back(tmp_path):
    """JAX pickle -> port load -> port save -> JAX load: the same weights,
    so the same predictions, bit for bit."""
    path = os.path.join(default_model_dir(), SHIPPED[1])
    t = tmodel.VariantModel(device="cpu")     # hidden 128: load rebuilds
    t.load(path)
    assert t.net.hidden == 96
    t.save(str(tmp_path / "port.pkl"))
    j0 = jmodel.VariantModel(hidden=96)
    j0.load(path)
    j1 = jmodel.VariantModel(hidden=96)
    j1.load(str(tmp_path / "port.pkl"))
    x = seeded_tensors(1)
    p0, p1 = j0.predict(x), j1.predict(x)
    for task in p0:
        assert np.array_equal(p0[task], p1[task])


def test_port_model_through_jax_and_back(tmp_path):
    """A port model (its own seeded init) -> save -> JAX load: predictions
    within tolerance; -> JAX save -> port load: the same state_dict."""
    t = tmodel.VariantModel(seed=5, hidden=24, device="cpu")
    t.save(str(tmp_path / "port.pkl"))
    j = jmodel.VariantModel(hidden=24)
    j.load(str(tmp_path / "port.pkl"))
    x = seeded_tensors(2, 64)
    assert_probs_close(t.predict(x), j.predict(x))
    j.save(str(tmp_path / "jax.pkl"))
    back = tmodel.VariantModel(hidden=24, device="cpu")
    back.load(str(tmp_path / "jax.pkl"))
    sd0, sd1 = t.net.state_dict(), back.net.state_dict()
    assert set(sd0) == set(sd1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_state_functions_round_trip():
    j = jmodel.VariantModel(seed=4, hidden=16)
    params = jax.device_get(j.params)
    net = state.variant_params_from_numpy(params, device="cpu")
    assert (net.hidden, net.slice_dim) == (16, 64)
    back = state.variant_params_to_numpy(net)
    flat0 = jax.tree_util.tree_flatten_with_path(params)[0]
    flat1 = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat0) == len(flat1) == 38     # 7 dense x 2, 2 cells x 12
    for key, value in flat0:
        assert np.array_equal(np.asarray(value), flat1[key]), key
    with pytest.raises(ValueError):
        state.load_variant_params(tmodel.ClairNet(hidden=32), params)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(50, 21)).astype(np.float32) * 3
    labels = rng.integers(0, 21, 50)
    got = tmodel.focal_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels)).numpy()
    ref = np.asarray(jmodel.focal_loss(logits, labels))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    outs = {t: rng.normal(size=(50, n)).astype(np.float32)
            for t, n in tmodel.HEAD_CLASSES.items()}
    labs = {t: rng.integers(0, n, 50) for t, n in tmodel.HEAD_CLASSES.items()}
    got = float(tmodel.multitask_loss(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        {k: torch.from_numpy(v) for k, v in labs.items()}))
    ref = float(jmodel.multitask_loss(outs, labs))
    assert abs(got - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("seed", [1, 2])
def test_training_trajectory_matches_jax(seed):
    x, labels = planted_world(seed)
    j = jmodel.VariantModel(seed=seed, hidden=32)
    t = tmodel.VariantModel(hidden=32, device="cpu")
    state.load_variant_params(t.net, jax.device_get(j.params))
    for step in range(5):
        lj, lt = j.train_step(x, labels), t.train_step(x, labels)
        assert abs(lj - lt) <= 1e-4 * abs(lj), (step, lj, lt)
    lj, lt = j.train_steps(x, labels, 25), t.train_steps(x, labels, 25)
    assert abs(lj - lt) <= 1e-2 * abs(lj), (lj, lt)
    # flax has one bias a gate: torch's second one stays 0 and untrained
    trained = {id(p) for g in t.opt.param_groups for p in g["params"]}
    for bias in t.net.recurrent_biases():
        assert not bias.requires_grad and id(bias) not in trained
        assert not bias.any()
    assert len(trained) == len(list(t.net.parameters())) - 2


def test_init_follows_flax():
    """Seeded init: the same seed gives the same net; biases 0; dense and
    LSTM input kernels a normal truncated at 2 sigma with variance
    1 / fan_in; each gate's recurrent kernel orthogonal."""
    a = tmodel.init_clairnet(tmodel.ClairNet(hidden=48), 9)
    b = tmodel.init_clairnet(tmodel.ClairNet(hidden=48), 9)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        if "bias" in k:
            assert not va.any(), k
    w = a.dense1.weight.detach()
    std = (1 / w.shape[1]) ** 0.5
    # +-2 of the unit normal, rescaled by the truncated one's 0.8796...
    assert w.abs().max() <= 2 * std / 0.87962566 + 1e-6
    assert abs(float(w.std()) / std - 1) < 0.05
    w_hh = a.lstm.weight_hh_l0_reverse
    for g in range(4):
        q = w_hh[g * 48:(g + 1) * 48]
        assert torch.allclose(q @ q.T, torch.eye(48), atol=1e-5)


def test_model_learns_synthetic_separation():
    """tests/test_variant.py's training test, on the port."""
    x, labels = planted_world(1, 256)
    m = tmodel.VariantModel(seed=0, hidden=32, device="cpu")
    first = m.train_step(x, labels)
    last = m.train_steps(x, labels, 150)
    assert last < first * 0.5, (first, last)
    acc = (m.predict(x)["zygosity"].argmax(1) == labels["zygosity"]).mean()
    assert acc > 0.9, acc


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.VariantModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpretrained.default_ensemble()


def test_variant_params_default_to_the_card():
    """state.variant_params_from_numpy defaults to device="cuda" like every
    other entry point of the port, and raises without a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = jax.device_get(jmodel.VariantModel(seed=4, hidden=16).params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.variant_params_from_numpy(params)


def test_gt21_labels_match():
    assert tmodel.GT21_LABELS == jmodel.GT21_LABELS
    for ref in range(4):
        for alt in range(4):
            for het in (False, True):
                assert tmodel.gt21_label_for_snv(ref, alt, het) \
                    == jmodel.gt21_label_for_snv(ref, alt, het)

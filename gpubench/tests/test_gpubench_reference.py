"""The plain reference: its DP against a loop, its trim judgement against
the port's trimming (and the control against it), the map numbers on
hand-made rows."""

import numpy as np
import pytest

from core import sim, worlds
from reference import map_check, profile_check, trim as ref_trim
from reference.sw import local_affine, pad_batch
from tests import tiny


def _naive(q, t, m, x, go, ge):
    n, mm = len(q), len(t)
    neg = -10 ** 9
    h = np.zeros((n + 1, mm + 1), int)
    e = np.full((n + 1, mm + 1), neg)
    f = np.full((n + 1, mm + 1), neg)
    col = np.zeros(mm, int)
    for i in range(1, n + 1):
        for j in range(1, mm + 1):
            e[i][j] = max(h[i][j - 1] - go, e[i][j - 1] - ge)
            f[i][j] = max(h[i - 1][j] - go, f[i - 1][j] - ge)
            s = m if q[i - 1] == t[j - 1] else -x
            h[i][j] = max(0, h[i - 1][j - 1] + s, e[i][j], f[i][j])
            col[j - 1] = max(col[j - 1], h[i][j])
    return h.max(), col


@pytest.mark.parametrize("scoring", [(3, 6, 5, 2), (2, 4, 4, 2)])
def test_local_affine_matches_a_loop(scoring):
    m, x, go, ge = scoring
    rng = np.random.default_rng(4)
    qs = [rng.integers(0, 4, rng.integers(3, 25)).astype(np.int8)
          for _ in range(6)]
    ts = [rng.integers(0, 4, rng.integers(3, 50)).astype(np.int8)
          for _ in range(6)]
    ts[0][:10] = qs[0][:10]
    best, col = local_affine(pad_batch(qs, "cpu"), pad_batch(ts, "cpu"),
                             match=m, mismatch=x, gap_open=go,
                             gap_extend=ge, want_colmax=True)
    for i in range(6):
        nb, nc = _naive(qs[i], ts[i], m, x, go, ge)
        assert int(best[i]) == nb
        assert np.array_equal(col[i, :len(ts[i])].numpy(), nc)


@pytest.fixture(scope="module")
def trim_world():
    cfg, tr = tiny.profile_world()
    tr["adapters"].update(middle_rate=0.3, end_rate=0.5)
    tr["profile"].update(length_log_mean=7.1)
    world = worlds.build(cfg, "cpu")
    rng, gen = sim.generators(21, 2, "cpu")
    r = worlds.simulate(world, tr, 160, rng, gen, adapters=cfg["adapters"],
                        with_quals=True)
    names = [f"r{i}" for i in range(len(r.reads))]
    params = dict(cfg["trim"], min_quality=0.0)
    return cfg, names, r, params


def _port_trim(cfg, reads, names, check_middle=True):
    from megapath_nano_tpu_torch.io.adapters import Adapter, trim_adapters

    ads = tuple(Adapter(a["name"], a["start"], a["end"])
                for a in cfg["adapters"])
    t = cfg["trim"]
    return trim_adapters(
        reads, names, ads, end_size=t["end_size"],
        end_threshold=t["end_threshold"],
        middle_threshold=t["middle_threshold"],
        extra_end_trim=t["extra_end_trim"],
        extra_middle_trim=t["extra_middle_trim"],
        min_split_size=t["min_split_size"], check_middle=check_middle)


def test_judge_holds_the_port_trim_right(trim_world):
    cfg, names, r, params = trim_world
    res = _port_trim(cfg, r.reads, names)
    assert res.n_start_trimmed > 50 and res.n_split > 5
    wrong, extra = ref_trim.judge(names, r.reads, r.quals, res.names,
                                  res.reads, params, cfg["adapters"], "cpu")
    assert extra == 0
    assert not wrong.any(), np.flatnonzero(wrong)


def test_reference_trim_is_judged_right(trim_world):
    cfg, names, r, params = trim_world
    out = ref_trim.trim(names, r.reads, r.quals, params, cfg["adapters"],
                        "cpu")
    res = _port_trim(cfg, r.reads, names)
    assert out[0] == res.names
    wrong, _ = ref_trim.judge(names, r.reads, r.quals, *out, params,
                              cfg["adapters"], "cpu")
    assert not wrong.any()


def test_control_without_middle_scan_is_wrong(trim_world):
    """The control: the reference's trim, and the port's own path, with the
    middle-adapter scan left out."""
    cfg, names, r, params = trim_world
    for out in (ref_trim.trim(names, r.reads, r.quals, params,
                              cfg["adapters"], "cpu", check_middle=False),
                (lambda t: (t.names, t.reads))(
                    _port_trim(cfg, r.reads, names, check_middle=False))):
        wrong, _ = ref_trim.judge(names, r.reads, r.quals, *out, params,
                                  cfg["adapters"], "cpu")
        assert wrong.sum() >= 5


def test_judge_sees_an_altered_base_and_a_lost_read(trim_world):
    cfg, names, r, params = trim_world
    res = _port_trim(cfg, r.reads, names)
    seqs = list(res.reads)
    seqs[3] = seqs[3].copy()
    seqs[3][len(seqs[3]) // 2] = (seqs[3][len(seqs[3]) // 2] + 1) % 4
    out_names = list(res.names)
    del out_names[7], seqs[7]
    wrong, _ = ref_trim.judge(names, r.reads, r.quals, out_names, seqs,
                              params, cfg["adapters"], "cpu")
    assert wrong.sum() == 2


def _rows(spec):
    from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE

    d = np.zeros(len(spec), ALIGN_DTYPE)
    for i, (rid, sid, sf, st, score) in enumerate(spec):
        d[i]["read_id"], d[i]["sequence_id"] = rid, sid
        d[i]["sequence_from"], d[i]["sequence_to"] = sf, st
        d[i]["alignment_score"] = score
    return d


def test_primary_and_misplaced():
    d = _rows([(0, 1, 100, 200, 50), (0, 0, 100, 200, 60),
               (2, 3, 0, 50, 10)])
    prim = map_check.primary_rows(d, 3)
    assert list(prim) == [1, -1, 2]
    bad = map_check.misplaced(d, prim, np.array([7, 7, 8]),
                              np.array([150, 0, 60]),
                              np.array([250, 10, 90]),
                              np.array([7, 7, 8, 8]))
    # read 0 on species 7 overlapping; read 1 unmapped; read 2 misses
    assert list(bad) == [False, True, True]


def test_score_numbers():
    over, short = map_check.score_numbers(np.array([10, 12, 8]),
                                          np.array([10, 11, 10]))
    assert over == 1 and short == pytest.approx(100 * 2 / 31)


def test_best_scores_see_a_whole_read():
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, 3000).astype(np.int8)
    read = genome[1000:1600].copy()
    d = _rows([(0, 0, 1200, 1400, 0)])
    d["read_from"], d["read_to"] = 200, 400
    best = map_check.best_scores(d, [read], genome, np.array([0, 3000]),
                                 dict(match=2, mismatch=4, gap_open=4,
                                      gap_extend=2), "cpu")
    assert best[0] == 2 * 600


def test_abundance_truth_and_gap():
    cov = profile_check.covered([(0, 10), (5, 20), (30, 40)])
    assert cov == 30
    ab = profile_check.true_abundance(
        np.array([0, 0, 1]), [[(0, 10)], [(5, 20)], [(0, 50)]],
        np.array([5, 6]), np.array([100, 100]))
    assert ab == {5: 25 * 20 / 100, 6: 50 * 50 / 100}
    gap = profile_check.abundance_gap({5: 1.0, 7: 1.0}, {5: 1.0})
    assert gap == pytest.approx(50.0)

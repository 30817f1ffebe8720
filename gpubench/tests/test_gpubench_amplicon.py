"""The amplicon cell at a tiny size on the CPU: the reference ClairNet
against the port's network, the reference pileup and candidates against
the port's, the reference's banded realignment score against the native
aligner's, the driver end to end, and `correct` coming out false with the
program broken underneath (a pileup count off by one, TF32 in the
network's matrix products, half the models' calls dropped, realignment
windows a base short, the VCF's depths off by one)."""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

import run
from core.spec import HERE, Spec
from reference import clairnet, variant_check

ROOT = os.path.dirname(HERE)


def amplicon_world():
    """The configuration and traffic at a size a CPU test holds: a 60 kb
    target and its relatives, the rest of the screen DB at 20 kb a genome,
    three amplicons of 400-600 b, 240 reads a sample (~70x), 6 SNVs."""
    with open(os.path.join(HERE, "configs", "h37rv_amplicon.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", "amplicon_ont.json")) as f:
        tr = json.load(f)
    cfg["name"] = "h37rv_tiny"
    cfg["world"]["species"][0]["genome_bp"] = 60000
    for sp in cfg["world"]["species"][1:]:
        sp["genome_bp"] = 20000
    cfg["amplicons"] = [{"locus": "a", "centre_kb": 8.0},
                        {"locus": "b", "centre_kb": 30.0},
                        {"locus": "c", "centre_kb": 50.0}]
    cfg["amplicon_bp"] = [400, 600]
    tr.update(reads_per_sample=240, pool=2, warmup_reads=30, check_sample=12)
    tr["snvs"].update(hom=4, het=2)
    return cfg, tr


def _run(cache, traced=False, seed=2 ** 31 + 7):
    cfg, tr = amplicon_world()
    return run.execute(Spec.load(ROOT), {"name": "amplicon.h37rv",
                                         "chips": 1}, cfg, tr, seed, 0.2,
                       traced, "cpu", time.perf_counter(),
                       cache_dir=str(cache))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


def test_reference_clairnet_matches_the_port():
    """Seeded random weights (not the shipped ones) at hidden 16: the
    reference's float32 forward within 1e-6 of the port's network, and its
    TF32 forward well outside."""
    from megapath_nano_tpu_torch.state import variant_params_to_numpy
    from megapath_nano_tpu_torch.variant.model import VariantModel

    rng = np.random.default_rng(3)
    x = rng.random((64, 33, 8, 4)).astype(np.float32)
    gaps, tf32 = [], []
    for seed in (1, 2):
        m = VariantModel(seed=seed, hidden=16, device="cpu")
        tree = variant_params_to_numpy(m.net)["params"]
        want = m.predict(x)
        for precision, out in (("float32", gaps), ("tf32", tf32)):
            got = clairnet.forward_blocks(clairnet.Net(tree, "cpu",
                                                       precision), x)
            out.append(max(float(np.abs(got[k] - want[k]).max())
                           for k in clairnet.HEADS))
    assert max(gaps) <= 1e-6, gaps
    assert min(tf32) > 1e-5, tf32


def test_reference_pileup_and_candidates_match_the_port():
    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.taxon.profiler import TaxonProfiler
    from megapath_nano_tpu_torch.utils.dna import (mutate, random_sequence,
                                                   revcomp)
    from megapath_nano_tpu_torch.variant import candidates

    rng = np.random.default_rng(5)
    ref = random_sequence(rng, 5000)
    donor = ref.copy()
    for p in (1200, 1333, 3400):
        donor[p] = (donor[p] + 1) % 4
    reads = []
    for k in range(160):
        lo, hi = (1000, 1700) if k % 2 else (3000, 3800)
        r = mutate(rng, (donor if k % 3 else ref)[lo:hi], sub_rate=0.03,
                   ins_rate=0.02, del_rate=0.03)
        reads.append(revcomp(r) if k % 4 < 2 else r)
    db = RefDB.build([ref], ["t"], [0], ["t"], [(1, 1, 1)])
    best = TaxonProfiler(db, device="cpu").profile(reads).best
    for seq_len in (len(ref), 3300):
        want = candidates.stranded_pileup(best, reads, 0, seq_len)
        rows = best.data[best.data["sequence_id"] == 0]
        got = variant_check.pileup(rows["read_id"], rows["sequence_from"],
                                   best.cigar_map, reads, 0, seq_len, "cpu")
        assert np.array_equal(got.numpy(), want)
    cands = candidates.extract_candidates(best, reads, 0, ref)
    counts = variant_check.pileup(rows["read_id"], rows["sequence_from"],
                                  best.cigar_map, reads, 0, len(ref), "cpu")
    pos = variant_check.candidates(counts, torch.as_tensor(ref))
    assert pos.tolist() == [c.position for c in cands] and len(cands) >= 3
    x = variant_check.tensors(counts, torch.as_tensor(ref), pos).numpy()
    want = np.stack([candidates.candidate_tensor(c, ref) for c in cands])
    assert np.abs(x - want).max() <= 1e-7


def test_reference_banded_score_matches_the_native_aligner():
    """The reference's banded DP gives the native aligner's score on
    windows shaped as realignment cuts them (the read's centre 100 b off
    the reference window's diagonal, and near a read's start, where the
    band loses it), and each native CIGAR walks to that score."""
    from megapath_nano_tpu_torch.native.banded import banded_align_batch
    from megapath_nano_tpu_torch.utils.dna import mutate, random_sequence

    from reference import realign_check

    rng = np.random.default_rng(11)
    ref = random_sequence(rng, 601)
    ref[300] = 4
    wins = []
    for k in range(24):
        lo = 100 if k % 3 else 200 + 10 * k
        w = mutate(rng, ref[lo:501], sub_rate=0.03, ins_rate=0.02,
                   del_rate=0.03)
        if k % 5 == 0:
            w[len(w) // 2] = 4
        wins.append(w)
    for band in (256, 128):
        alns = banded_align_batch(wins, [ref] * len(wins), band=band,
                                  **realign_check.SCORES)
        best = realign_check.banded_best(wins, ref, "cpu", band=band,
                                         **realign_check.SCORES)
        assert best.tolist() == [a.score for a in alns]
        for w, a in zip(wins, alns):
            s, _ = realign_check.walk(a.cigar, a.read_begin, a.ref_begin,
                                      w, ref, 300, **realign_check.SCORES)
            assert s == a.score
    # the band loses windows cut near a read's start
    assert min(best) < max(best)


def test_driver_end_to_end(cache):
    res = _run(cache, traced=True)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0
    names = set(res["metrics"])
    assert {"reads_per_s.amplicon", "pileup_ms_per_kread.amplicon",
            "realign_ms_per_kread.amplicon",
            "model_fill_pct.amplicon"} <= names
    # no CUDA kernels on the CPU: the device readers find nothing
    assert "clairnet_roofline_pct.amplicon" not in names
    fill = res["metrics"]["model_fill_pct.amplicon"]["value"]
    assert 0 < fill <= 100
    assert res["notes"]["model_calls"] > 0 and res["notes"]["candidates"]
    assert res["checks"]["prob_gap"]["value"] <= 1e-6
    assert sum(res["notes"]["realign_pairs"]) > 0
    assert {"seed_ms_per_kread.amplicon", "traceback_ms_per_kread.amplicon",
            "extend_fill_pct.amplicon", "window_pad_pct.amplicon",
            "traceback_redo_pct.amplicon"} <= names


def _pileup_off_by_one(monkeypatch):
    from megapath_nano_tpu_torch.variant import candidates

    orig = candidates.stranded_pileup

    def off(*a, **kw):
        c = orig(*a, **kw)
        c[5, int(np.argmax(c[5].sum(1))), 1] += 1
        return c
    monkeypatch.setattr(candidates, "stranded_pileup", off)


def _tf32(monkeypatch):
    """TF32 in the network's matrix products: what the card does with
    `allow_tf32`, here by rounding the weights and inputs to TF32."""
    from megapath_nano_tpu_torch.variant import model

    orig = model.VariantModel.predict

    def predict(self, batch):
        saved = {k: v.clone() for k, v in self.net.state_dict().items()}
        with torch.no_grad():
            for v in self.net.state_dict().values():
                v.copy_(clairnet.tf32_round(v))
        try:
            x = clairnet.tf32_round(torch.as_tensor(batch)).numpy()
            return orig(self, x)
        finally:
            self.net.load_state_dict(saved)
    monkeypatch.setattr(model.VariantModel, "predict", predict)


def _half_calls(monkeypatch):
    from megapath_nano_tpu_torch.variant import caller

    orig = caller.call_variants

    @functools.wraps(orig)
    def half(*a, **kw):
        calls = orig(*a, **kw)
        return calls[: len(calls) // 2]
    monkeypatch.setattr(caller, "call_variants", half)


def _realign_window_short(monkeypatch):
    from megapath_nano_tpu_torch.variant import realign

    monkeypatch.setattr(realign, "READ_WINDOW", realign.READ_WINDOW - 1)


def _vcf_depth_off(monkeypatch):
    from megapath_nano_tpu_torch.variant import caller

    orig = caller.write_vcf

    def write(path, calls, seq_names):
        for c in calls:
            c.depth += 1
        return orig(path, calls, seq_names)
    monkeypatch.setattr(caller, "write_vcf", write)


@pytest.mark.parametrize("fault,number", [
    (_pileup_off_by_one, "pileup_wrong"),
    (_tf32, "prob_gap"),
    (_half_calls, "calls_differ"),
    (_realign_window_short, "realign_wrong"),
    (_vcf_depth_off, "vcf_differ"),
])
def test_broken_path_is_not_correct(fault, number, cache, monkeypatch):
    fault(monkeypatch)
    res = _run(cache)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]

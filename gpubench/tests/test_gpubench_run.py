"""Whole runs at a tiny size on the CPU: the result line, the trace, and
`correct` coming out false with the timed path broken underneath."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import run
from core.spec import HERE, Spec
from tests import tiny

ROOT = os.path.dirname(HERE)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(which, cache, traced=False, seed=2 ** 31 + 5):
    cfg, tr = {"map": tiny.map_world, "map20k": tiny.map_world_20k,
               "profile": tiny.profile_world}[which]()
    name = "profile.zymo.trim" if which == "profile" else "map.refseq1g.ont"
    return run.execute(Spec.load(ROOT), {"name": name, "chips": 1}, cfg, tr,
                       seed, 0.2, traced, "cpu", time.perf_counter(),
                       cache_dir=str(cache))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


@pytest.mark.parametrize("which", ["map", "profile"])
def test_result_line(which, cache, capsys):
    res = _run(which, cache)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["metrics"]["setup_s"]["value"] > 0
    # the end-to-end kernel time reads CUDA kernels: none on the CPU, so
    # the reader returns nothing and the line leaves the metric out
    assert "kernel_ms_per_kread" not in res["metrics"]
    assert not {"reads_per_s.profile", "bases_per_s.map"} & \
        set(res["metrics"])
    run.print_result(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == list(res)
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("which", ["map", "profile"])
def test_traced_result_line(which, cache):
    """The map run has reads over 16,384 b, as the cell's calls do, so its
    host readers find something on the CPU too."""
    res = _run("map20k" if which == "map" else which, cache, traced=True)
    assert res["correct"] is True
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(res["metrics"])
    if which == "profile":
        assert {"reads_per_s.profile", "load_db_s.profile",
                "trim_ms_per_read.profile",
                "placement_ms_per_read.profile"} <= names
        assert res["metrics"]["reads_per_s.profile"]["unit"] == "reads/s"
    else:
        assert {"bases_per_s.map", "seed_host_ms_per_kread.map",
                "traceback_host_ms_per_kread.map"} <= names
        assert res["metrics"]["bases_per_s.map"]["unit"] == "bases/s"
        assert res["notes"]["sw_scores_calls"] > 0
        assert res["notes"]["sw_full_calls"] == 0
    assert "kernel_ms_per_kread" not in names


def _half_map(monkeypatch):
    from megapath_nano_tpu_torch.align import pipeline

    orig = pipeline.MinimizerAligner.map_reads

    def half(self, reads, *a, **kw):
        al = orig(self, reads, *a, **kw)
        al.data = al.data[al.data["read_id"] < len(reads) // 2]
        return al
    monkeypatch.setattr(pipeline.MinimizerAligner, "map_reads", half)


def _bumped_scores(monkeypatch):
    from megapath_nano_tpu_torch.align import pipeline

    orig = pipeline.MinimizerAligner.map_reads

    def bump(self, reads, *a, **kw):
        al = orig(self, reads, *a, **kw)
        al.data["alignment_score"] += 1
        return al
    monkeypatch.setattr(pipeline.MinimizerAligner, "map_reads", bump)


def _altered_trim(monkeypatch):
    from megapath_nano_tpu_torch.io import adapters

    orig = adapters.trim_adapters

    def alter(reads, names, *a, **kw):
        res = orig(reads, names, *a, **kw)
        res.reads = [np.where(np.arange(len(r)) == 0, (r + 1) % 4, r)
                     .astype(np.int8) for r in res.reads]
        return res
    monkeypatch.setattr(adapters, "trim_adapters", alter)


def _no_middle_scan(monkeypatch):
    """The control on the program's own path: trimming without the
    middle-adapter scan."""
    from megapath_nano_tpu_torch.io import adapters

    orig = adapters.trim_adapters

    def no_middle(reads, names, *a, **kw):
        return orig(reads, names, *a, check_middle=False, **kw)
    monkeypatch.setattr(adapters, "trim_adapters", no_middle)


def _doubled_top(monkeypatch):
    from megapath_nano_tpu_torch.report import writers
    from megapath_nano_tpu_torch.taxon import profiler

    def write_preport(path, stat, tax_names=None):
        rows = writers.species_abundance(stat)
        with open(path, "w") as f:
            f.write("species_tax_id\tname\tadjusted_abundance\n")
            for i, (sp, ab) in enumerate(rows):
                f.write(f"{sp}\t{sp}\t{2 * ab if i == 0 else ab}\n")
    monkeypatch.setattr(profiler, "write_preport", write_preport)


@pytest.mark.parametrize("which,fault,number", [
    ("map", _half_map, "misplaced_pct"),
    ("map", _bumped_scores, "score_over"),
    ("profile", _altered_trim, "trim_wrong"),
    ("profile", _no_middle_scan, "trim_wrong"),
    ("profile", _half_map, "misplaced_pct"),
    ("profile", _doubled_top, "abundance_gap_pp"),
])
def test_broken_path_is_not_correct(which, fault, number, cache,
                                    monkeypatch):
    fault(monkeypatch)
    res = _run(which, cache)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_map_control_is_not_correct(tmp_path, monkeypatch):
    """The control of the map cell: the program with its band fixed at 128
    (the traffic's control_band) instead of the band its reads need."""
    import functools

    from megapath_nano_tpu_torch.align import pipeline

    cfg, tr = tiny.map_world_long()
    monkeypatch.setattr(pipeline, "AlignParams",
                        functools.partial(pipeline.AlignParams,
                                          band=tr["control_band"]))
    res = run.execute(Spec.load(ROOT), {"name": "map.refseq1g.ont",
                                        "chips": 1}, cfg, tr, 5, 0.1, False,
                      "cpu", time.perf_counter(), cache_dir=str(tmp_path))
    assert res["correct"] is False
    c = res["checks"]["score_short_pct"]
    assert c["value"] > c["limit"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "map.refseq1g.ont", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_bare_directory_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and gpubench/ prints no
    result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "map.refseq1g.ont",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_map_on_the_card(card, tmp_path):
    """The tiny map cell through the kernels (the card only)."""
    cfg, tr = tiny.map_world()
    res = run.execute(Spec.load(ROOT), {"name": "map.refseq1g.ont",
                                        "chips": 1}, cfg, tr, 3, 0.2, True,
                      card, time.perf_counter(), cache_dir=str(tmp_path))
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0

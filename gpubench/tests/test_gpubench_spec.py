"""BENCHMARK.json resolves to the harness's files and keeps the contract's
shape."""

import json
import os
import re

import pytest

from core.spec import HERE, Spec

ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"]
    assert bench["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_cell_resolves(bench):
    spec = Spec.load(ROOT)
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        traffic = spec.traffic(w["traffic"])
        driver = spec.driver(traffic["driver"])
        assert callable(driver.setup)
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert set(traffic["limits"]) <= set(("trim_wrong", "misplaced_pct",
                                              "abundance_gap_pp",
                                              "score_over",
                                              "score_short_pct"))


def test_every_config_used_and_its_file(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("gpubench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_metric_resolves(bench):
    spec = Spec.load(ROOT)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.reader(m["name"]).read)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = next(e for e in bench["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_enough(bench):
    spec = Spec.load(ROOT)
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(w["name"], True)


def test_names(bench):
    for group in ("configs", "workloads"):
        for x in bench[group]:
            assert NAME.match(x["name"]), x["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"])

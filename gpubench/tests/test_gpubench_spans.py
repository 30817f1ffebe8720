"""The metrics that read the program's own spans and counters
(`core/spans.py`), in traced runs of the tiny CPU cells on the map's host
path, as the cells' reads over 16,384 b take it on the card: each reads a
value. Without the program's record the readers give nothing and raise
nothing."""

import time

import pytest

import run
from core import spans
from core.spec import Spec
from tests import tiny
from tests.test_gpubench_run import ROOT

MAP = ["windows_host_ms_per_kread.map", "fetch_wait_ms_per_kread.map",
       "unspanned_pct.map", "window_pad_pct", "traceback_redo_pct"]
PROFILE = ["window_pad_pct", "traceback_redo_pct",
           "trim_scan_mcells_per_s.profile"]


def _host_path(monkeypatch):
    """Every map of the profile's placement in CIGAR mode: the host path
    (windows, the score-only kernel, the host traceback) on reads short
    enough for the plain versions."""
    from megapath_nano_tpu_torch.align import pipeline

    orig = pipeline.MinimizerAligner.map_reads

    def cigar(self, reads, read_names=None, slice_size=None,
              emit_cigars=True):
        return orig(self, reads, read_names, slice_size=slice_size,
                    emit_cigars=True)
    monkeypatch.setattr(pipeline.MinimizerAligner, "map_reads", cigar)


def _run(which, tmp_path):
    cfg, tr = {"map": tiny.map_world_20k, "profile": tiny.profile_world}[
        which]()
    name = "profile.zymo.trim" if which == "profile" else "map.refseq1g.ont"
    return run.execute(Spec.load(ROOT), {"name": name, "chips": 1}, cfg, tr,
                       2 ** 31 + 5, 0.2, True, "cpu", time.perf_counter(),
                       cache_dir=str(tmp_path))


@pytest.mark.parametrize("which", ["map", "profile"])
def test_span_metrics_read(which, tmp_path, monkeypatch):
    if which == "profile":
        _host_path(monkeypatch)
    res = _run(which, tmp_path)
    assert res["correct"] is True
    m = res["metrics"]
    for name in MAP if which == "map" else PROFILE:
        assert name in m, name
        assert m[name]["value"] >= 0, name
    if which == "map":
        assert 0 <= m["unspanned_pct.map"]["value"] < 100
        assert 0 < m["window_pad_pct"]["value"] < 100
    else:
        assert m["trim_scan_mcells_per_s.profile"]["value"] > 0
        assert m["trim_scan_mcells_per_s.profile"]["unit"] == "Mcells/s"


def test_no_record_no_value(monkeypatch):
    """A program without `RECORD` (an earlier version) reads nothing."""
    from megapath_nano_tpu_torch.utils import log

    monkeypatch.delattr(log, "RECORD")
    run_ = run.Run(workload="map.refseq1g.ont", cell=None,
                   requests=[{"kind": "map_call", "reads": 4, "ok": True}],
                   window_s=1.0, setup_s=1.0)
    spec = Spec.load(ROOT)
    assert spans.window(run_) is None
    for name in set(MAP + PROFILE):
        assert spec.reader(name).read(run_) is None, name

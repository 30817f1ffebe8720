"""extend_fill_pct, the reader of the program's `ext_rows` and
`ext_rows_launched` counters (`map.extend`): a hand-made record reads the
share computed by hand, the tiny CPU cells on the map's host path read a
value, and a program without the counters or without the record reads
nothing and raises nothing."""

import pytest

import run
from core.spec import Spec
from tests.test_gpubench_spans import _host_path, _run

NAME = "extend_fill_pct"


def _one_call(counts):
    """One `map.call` root in the program's record, with a `map.extend`
    child carrying `counts`; the Run of a window of that one call."""
    from megapath_nano_tpu_torch.utils.log import count, span

    with span("map.call"):
        with span("map.slice"):
            with span("map.extend"):
                for key, n in counts.items():
                    count(key, n)
    return run.Run(workload="map.refseq1g.ont", cell=None,
                   requests=[{"kind": "map_call", "reads": 4, "ok": True}],
                   window_s=1.0, setup_s=1.0)


def test_reads_the_share_by_hand():
    # two launches of 8 pairs: longest queries 900 and 300, 7,000 rows
    run_ = _one_call({"ext_rows": 7000,
                      "ext_rows_launched": 8 * 900 + 8 * 300})
    assert Spec.reader(NAME).read(run_) == pytest.approx(
        100.0 * 7000 / 9600)


def test_program_without_the_counters_reads_nothing():
    """A program that counts only the windows (an earlier version)."""
    run_ = _one_call({"windows": 16, "window_bytes": 9000,
                      "window_bytes_padded": 16384})
    assert Spec.reader(NAME).read(run_) is None


def test_no_record_no_value(monkeypatch):
    from megapath_nano_tpu_torch.utils import log

    monkeypatch.delattr(log, "RECORD")
    run_ = run.Run(workload="map.refseq1g.ont", cell=None,
                   requests=[{"kind": "map_call", "reads": 4, "ok": True}],
                   window_s=1.0, setup_s=1.0)
    assert Spec.reader(NAME).read(run_) is None


@pytest.mark.parametrize("which", ["map", "profile"])
def test_tiny_cells_read_a_share(which, tmp_path, monkeypatch):
    if which == "profile":
        _host_path(monkeypatch)
    res = _run(which, tmp_path)
    assert res["correct"] is True
    assert 0 < res["metrics"][NAME]["value"] <= 100
    assert res["metrics"][NAME]["unit"] == "%"

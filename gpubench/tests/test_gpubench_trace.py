"""The trace arithmetic on hand-made events: the device's busy time is the
union of kernels and copies, the kernel time the union of kernels alone,
and the end-to-end kernel time is read per thousand completed reads."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from core import trace
from core.spec import Spec


def _ev(name, a, b, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=a, end=b),
                           device_time_total=0.0)


def test_kernel_time_leaves_copies_out():
    events = [_ev("sw_scores_warp_kernel", 0, 100_000),
              _ev("chain_kernel", 50_000, 150_000),       # overlaps: union
              _ev("Memcpy HtoD (Pageable -> Device)", 200_000, 500_000),
              _ev("Memset (Device)", 600_000, 610_000),
              _ev("aten::add", 0, 900_000, DeviceType.CPU)]
    tr = trace.reduce(events, 1.0)
    assert tr.kernel_busy_s == pytest.approx(0.15)
    assert tr.busy_s == pytest.approx(0.46)
    assert tr.n_kernels == 2 and tr.n_device_ops == 4


def test_kernel_ms_per_kread_reader():
    reader = Spec.reader("kernel_ms_per_kread")
    tr = trace.reduce([_ev("sw_scores_warp_kernel", 0, 300_000)], 1.0)
    reqs = [{"kind": "map_call", "reads": 2000, "ok": True},
            {"kind": "map_call", "reads": 1000, "ok": True},
            {"kind": "failed", "ok": False}]
    run = SimpleNamespace(trace=tr, requests=reqs)
    assert reader.read(run) == pytest.approx(100.0)    # 300 ms / 3 kreads
    run = SimpleNamespace(trace=trace.reduce([], 1.0), requests=reqs)
    assert reader.read(run) is None

"""Device trace of a measured window: torch.profiler, reduced to numbers.

The arithmetic is a frozen copy of `chip_smoke.py`'s `traced`: the device's
busy time is the union of the intervals of its kernels and copies, and the
kernel time by name is the sum of their durations. On top of it:

- the kernels' busy time: the union of the kernels' intervals alone,
  copies and sets left out (a pageable copy's time follows the host);
- the device time of the kernels launched inside one of the harness's own
  `record_function` ranges (a range named `gpubench.<what>`);
- the idle gaps between busy intervals, each named by the innermost
  harness range open on the host at the gap's middle (`host` where none),
  summed by name;
- the breakdown line: the ten device operations that took most time and
  the ten names under which the device stood idle longest.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

RANGE_PREFIX = "gpubench."


def is_range(name: str) -> bool:
    return name.startswith(RANGE_PREFIX)


@contextmanager
def span(name: str, enabled: bool = True):
    """A harness range around a call into the program (traced runs only)."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(RANGE_PREFIX + name):
        yield


def union(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """(total length, merged intervals) of [start, end) intervals."""
    if not intervals:
        return 0.0, []
    iv = sorted(intervals)
    merged = [list(iv[0])]
    for a, b in iv[1:]:
        if a > merged[-1][1]:
            merged.append([a, b])
        elif b > merged[-1][1]:
            merged[-1][1] = b
    return sum(b - a for a, b in merged), merged


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_busy_s: float = 0.0
    n_device_ops: int = 0
    n_kernels: int = 0
    kernels: dict = field(default_factory=dict)   # name -> [seconds, count]
    ranges: dict = field(default_factory=dict)    # name -> device seconds
    gaps: dict = field(default_factory=dict)      # label -> idle seconds

    def kernel_s(self, fragment: str) -> float:
        return sum(v[0] for k, v in self.kernels.items() if fragment in k)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[label, s] for label, s in gaps]}


class Tracer:
    """Profile a window. `window()` wraps the measured loop; `trace` holds
    the numbers after it closes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.trace: Trace | None = None

    def warm(self):
        """The first trace of a process pays the tracer's start-up."""
        with torch.profiler.profile(activities=self._acts()):
            torch.zeros(1, device=self.device)
            self._sync()

    def _acts(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def window(self):
        prof = torch.profiler.profile(activities=self._acts())
        prof.__enter__()
        t0 = time.perf_counter()
        try:
            yield
            self._sync()
        finally:
            wall = time.perf_counter() - t0
            prof.__exit__(None, None, None)
        self.trace = reduce(prof.events(), wall)


def reduce(events, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    tr = Trace(window_s=window_s)
    spans, kernel_spans, host_ranges = [], [], []
    for ev in events:
        if ev.device_type == DeviceType.CPU:
            if is_range(ev.name):
                host_ranges.append((ev.time_range.start, ev.time_range.end,
                                    ev.name[len(RANGE_PREFIX):]))
                tr.ranges[ev.name[len(RANGE_PREFIX):]] = \
                    tr.ranges.get(ev.name[len(RANGE_PREFIX):], 0.0) \
                    + ev.device_time_total / 1e6
            continue
        if is_range(ev.name) or ev.name.startswith("ProfilerStep"):
            continue            # annotations of ranges, not device work
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        rec = tr.kernels.setdefault(ev.name, [0.0, 0])
        rec[0] += (b - a) / 1e6
        rec[1] += 1
        tr.n_device_ops += 1
        if not ev.name.startswith(("Memcpy", "Memset")):
            tr.n_kernels += 1
            kernel_spans.append((a, b))
    busy_us, merged = union(spans)
    tr.busy_s = busy_us / 1e6
    tr.kernel_busy_s = union(kernel_spans)[0] / 1e6
    host_ranges.sort(key=lambda r: r[1] - r[0])
    for (_, end), (start, _) in zip(merged[:-1], merged[1:]):
        mid = (end + start) / 2
        label = next((n for a, b, n in host_ranges if a <= mid <= b), "host")
        tr.gaps[label] = tr.gaps.get(label, 0.0) + (start - end) / 1e6
    return tr

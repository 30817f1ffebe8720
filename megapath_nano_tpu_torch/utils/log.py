"""Structured step logging with wall-clock stamps, and the port's span and
counter record.

The reference logs `program: function(): message` lines with timestamps per
step (reference: bin/megapath_nano.py:157-175 Log.print_time). Here each
pipeline step is a context manager that records duration, giving both the
human log line and a machine-readable timing table for observability. The
`Log` class is the port's own copy of megapath_nano_tpu/utils/log.py.

Beside it, the record of where the host's time goes:

- `span(name)` is a context manager. A finished span keeps its name, its
  id, its parent's id, its root's id (the request: every span under one
  `cli.main` or `map.call` shares it), the thread, its start and end in ns,
  and the counts added while it was the innermost open span.
- `count(name, n)` adds n to the innermost open span. Callers sum locally
  and count once per slice or call; spans go at stage granularity (at most
  64 a map slice), never per read or per window.
- The open span lives in a `contextvars.ContextVar`: code that hands work to
  a thread runs it under `contextvars.copy_context()` of the caller, so the
  work's spans are children of the caller's.
- Stamps are ns since the Unix epoch (a monotonic clock plus one offset
  taken at import), the clock torch.profiler stamps its events with, so a
  span lines up with a profiler's trace of the same process. A span opens
  no profiler range: the profiler would put every range that encloses a
  launch on the device's timeline as well, as if it were device work.
- Finished spans go to `RECORD`, a ring of `CAPACITY` spans that counts
  what it drops, so a long-running process holds a bounded record.
- No span or counter touches the device or waits for it.

`write_chrome_trace` writes spans as Chrome-trace JSON (the CLI's
`--span_trace`).
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

CAPACITY = 65536
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """ns since the Unix epoch, on a monotonic clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


@dataclass(eq=False)
class Span:
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class SpanRecord:
    """The finished spans of a process: a ring of `capacity`, oldest first
    (in order of finishing), and how many it dropped."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, s: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(s)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._ring)

    def request(self, root: int) -> list[Span]:
        """The spans of one request (root span id), its root last."""
        return [s for s in self.spans() if s.root == root]


RECORD = SpanRecord()
_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "megapath_nano_tpu_torch_span", default=None)
_ids = itertools.count(1)


@contextmanager
def span(name: str):
    """Record the body as a span (child of the innermost open span)."""
    parent = _current.get()
    sid = next(_ids)
    s = Span(name, sid, parent.id if parent else None,
             parent.root if parent else sid, threading.get_native_id())
    token = _current.set(s)
    s.start_ns = now_ns()
    try:
        yield s
    finally:
        s.end_ns = now_ns()
        _current.reset(token)
        RECORD.add(s)


def count(name: str, n: int = 1) -> None:
    """Add n to the innermost open span's count `name` (none open: no-op)."""
    s = _current.get()
    if s is not None:
        s.counts[name] = s.counts.get(name, 0) + int(n)


def write_chrome_trace(path: str, spans: list[Span]) -> None:
    """Spans as Chrome-trace JSON: one complete event a span, one track a
    thread, ids and counts as args. `ts` is in µs since the Unix epoch
    (`baseTimeNanoseconds` 0), so adding a torch.profiler export's own
    `baseTimeNanoseconds` to its `ts` puts both on one timeline."""
    pid = os.getpid()
    events = [{"ph": "X", "cat": "mpn", "name": s.name, "pid": pid,
               "tid": s.thread, "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": dict(s.counts, id=s.id, parent=s.parent,
                            root=s.root)}
              for s in spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": 0}, f)


class Log:
    def __init__(self, program: str, stream=None, enabled: bool = True):
        self.program = program
        self.stream = stream or sys.stderr
        self.enabled = enabled
        self.timings: list[tuple[str, float]] = []

    def message(self, text: str) -> None:
        if self.enabled:
            ts = time.strftime("%Y-%m-%d %H:%M:%S")
            print(f"{ts} {self.program}: {text}", file=self.stream)

    @contextmanager
    def step(self, name: str):
        """A step: its log lines and `.timing` row, and a `step.<name>`
        span around its body."""
        t0 = time.time()
        self.message(f"{name}: start")
        try:
            with span("step." + name):
                yield
        finally:
            dt = time.time() - t0
            self.timings.append((name, dt))
            self.message(f"{name}: done in {dt:.2f}s")

    def timing_table(self) -> str:
        return "\n".join(f"{name}\t{dt:.3f}" for name, dt in self.timings)

"""Structured step logging with wall-clock stamps.

The reference logs `program: function(): message` lines with timestamps per
step (reference: bin/megapath_nano.py:157-175 Log.print_time). Here each
pipeline step is a context manager that records duration, giving both the
human log line and a machine-readable timing table for observability.

The port's own copy of megapath_nano_tpu/utils/log.py.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager


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
        t0 = time.time()
        self.message(f"{name}: start")
        try:
            yield
        finally:
            dt = time.time() - t0
            self.timings.append((name, dt))
            self.message(f"{name}: done in {dt:.2f}s")

    def timing_table(self) -> str:
        return "\n".join(f"{name}\t{dt:.3f}" for name, dt in self.timings)

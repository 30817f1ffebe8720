"""The program's own span and counter record, as the metric readers see it.

The port keeps every finished span in `megapath_nano_tpu_torch.utils.log`'s
`RECORD` (name, id, parent, root, thread, start and end in ns, counts). The
window's spans are those whose request (root span) is one of the last
`len(run.requests)` roots named after the cell's request: `cli.main` for a
sample, `map.call` for a map call. Set-up and warm-up requests come before
the window, and `check()` calls no program code, so nothing comes after it.

A program without the record (a version before it) gives None, and so does
a window whose first request may have lost spans to the ring's bound.
"""

from __future__ import annotations

import sys

ROOTS = {"sample": "cli.main", "map_call": "map.call"}


def window(run):
    """The program's spans of the measured window, or None."""
    mod = sys.modules.get("megapath_nano_tpu_torch.utils.log")
    record = getattr(mod, "RECORD", None)
    kinds = {r["kind"] for r in run.requests}
    if record is None or len(kinds) != 1 or not kinds <= set(ROOTS):
        return None
    name = ROOTS[kinds.pop()]
    spans = record.spans()
    roots = [s for s in spans if s.parent is None and s.name == name]
    n = len(run.requests)
    if len(roots) < n:
        return None
    first = roots[-n]
    if record.dropped and spans[0].start_ns > first.start_ns:
        return None
    ids = {s.id for s in roots[-n:]}
    return [s for s in spans if s.root in ids]


def named(spans, name):
    return [s for s in spans if s.name == name]


def seconds(spans, *names):
    """Summed seconds of the spans with these names (over every thread)."""
    return sum(s.seconds for s in spans if s.name in names)


def counted(spans, key):
    """A count summed over the spans that carry it."""
    return sum(s.counts.get(key, 0) for s in spans)


def covered_ns(parent, children) -> int:
    """ns of the parent's interval that the children's intervals cover."""
    iv = sorted((max(c.start_ns, parent.start_ns),
                 min(c.end_ns, parent.end_ns)) for c in children)
    total, end = 0, parent.start_ns
    for a, b in iv:
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total

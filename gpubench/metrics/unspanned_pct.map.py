"""unspanned_pct.map: the share of the window's `map.slice` time that no
child span of a slice covers (time the program's spans leave unnamed)."""

from core import spans


def read(run):
    sp = spans.window(run)
    slices = spans.named(sp or [], "map.slice")
    total = sum(s.end_ns - s.start_ns for s in slices)
    if not total:
        return None
    kids = {}
    for s in sp:
        kids.setdefault(s.parent, []).append(s)
    covered = sum(spans.covered_ns(s, kids.get(s.id, [])) for s in slices)
    return 100.0 * (1.0 - covered / total)

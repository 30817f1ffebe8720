"""traceback_redo_pct: the share of host tracebacks redone at the full band
because the narrow band's score missed the device's: 100 x `traceback_redo`
/ `traceback_pairs`, the program's counters of `map.traceback`, summed over
the window."""

from core import spans


def read(run):
    sp = spans.window(run)
    if not sp:
        return None
    pairs = spans.counted(sp, "traceback_pairs")
    if not pairs:
        return None
    return 100.0 * spans.counted(sp, "traceback_redo") / pairs

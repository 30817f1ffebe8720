"""trim_scan_mcells_per_s.profile: adapter scan cells (adapter length x
window length, summed over the SSW scans, the program's `scan_cells`
count) over the seconds of the program's `trim` spans, in millions a
second, over the window's samples."""

from core import spans


def read(run):
    sp = spans.window(run)
    trims = spans.named(sp or [], "trim")
    secs = spans.seconds(trims, "trim")
    if not trims or secs <= 0:
        return None
    return spans.counted(trims, "scan_cells") / secs / 1e6

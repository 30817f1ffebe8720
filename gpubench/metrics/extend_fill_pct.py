"""extend_fill_pct: how much of the score-only extension launches on the
host path is the windows' own rows: 100 x `ext_rows` / `ext_rows_launched`,
the program's counters of `map.extend` (the windows' query lengths against,
launch by launch, its pairs times its longest query), summed over the
window. A program without the counters reads nothing."""

from core import spans


def read(run):
    sp = spans.window(run)
    if not sp:
        return None
    launched = spans.counted(sp, "ext_rows_launched")
    if not launched:
        return None
    return 100.0 * spans.counted(sp, "ext_rows") / launched

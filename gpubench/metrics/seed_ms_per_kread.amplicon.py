"""seed_ms_per_kread.amplicon: host time in the program's
`map.seed` spans (`collect_anchors` in both maps of a sample, the screen's
and align_to_target's, summed over the map's threads), in ms per thousand
input reads of the window's samples. A program without the span reads
nothing."""

from core import readings, spans


def read(run):
    sp = spans.window(run)
    reads = readings.completed(run, "reads")
    if not sp or not reads or not spans.named(sp, "map.seed"):
        return None
    return 1e6 * spans.seconds(sp, "map.seed") / reads

"""traceback_ms_per_kread.amplicon: host time in the program's
`map.traceback` spans (both `banded_align_batch` calls of the maps' host
path, in the screen and in align_to_target, summed over the map's
threads), in ms per thousand input reads of the window's samples. A
program without the span reads nothing."""

from core import readings, spans


def read(run):
    sp = spans.window(run)
    reads = readings.completed(run, "reads")
    if not sp or not reads or not spans.named(sp, "map.traceback"):
        return None
    return 1e6 * spans.seconds(sp, "map.traceback") / reads

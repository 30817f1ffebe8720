"""realign_ms_per_kread.amplicon: host time in the program's
`variant.realign` spans (`realign_candidates`: covering reads, their local
windows, the native banded realignment and the recount), in ms per
thousand input reads of the window's samples. A program without the span
reads nothing."""

from core import readings, spans


def read(run):
    sp = spans.window(run)
    reads = readings.completed(run, "reads")
    if not sp or not reads or not spans.named(sp, "variant.realign"):
        return None
    return 1e6 * spans.seconds(sp, "variant.realign") / reads

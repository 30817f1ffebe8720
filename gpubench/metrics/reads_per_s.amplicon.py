"""reads_per_s.amplicon: input reads of every amplicon sample completed in
the traced window over the time from the window's start to the last
completion (host clock): the amplicon pipeline's wall rate."""

from core import readings


def read(run):
    return readings.rate(run, "amplicon_sample", "reads")

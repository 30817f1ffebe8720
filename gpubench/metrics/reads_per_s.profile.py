"""reads_per_s.profile: input reads of every sample completed in the traced
window over the time from the window's start to the last completion (host
clock): the profile's wall rate, per layer since it spreads with the host."""

from core import readings


def read(run):
    return readings.rate(run, "sample", "reads")

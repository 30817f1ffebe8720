"""bases_per_s.map: read bases of every map call completed in the traced
window over the time from the window's start to the last completion (host
clock): the map's wall rate, per layer since it spreads with the host."""

from core import readings


def read(run):
    return readings.rate(run, "map_call", "bases")

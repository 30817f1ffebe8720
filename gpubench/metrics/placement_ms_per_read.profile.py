"""placement_ms_per_read.profile: the profile's `placement_to_species` step
(`.timing`; it ends in a fetch, so the device's work is inside) in ms, over
the samples' input reads."""

from core import readings


def read(run):
    return readings.step_ms_per_read(run, "placement_to_species")

"""trim_ms_per_read.profile: the CLI's `adaptor_trimming` step (`.timing`)
in ms, over the samples' input reads."""

from core import readings


def read(run):
    return readings.step_ms_per_read(run, "adaptor_trimming")

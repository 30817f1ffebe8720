"""load_db_s.profile: the CLI's `load_db` step (`.timing`), seconds a
sample."""

from core import readings


def read(run):
    total, n = readings.step_total(run, "load_db")
    return total / n if n else None

"""traceback_host_ms_per_kread.map: host time inside the program's
`banded_align_batch` (the native banded traceback that gives an emitted
alignment its fields where a window is too long for the full-stats
kernel), summed over the map's worker threads, in ms per thousand reads
mapped."""

from core import readings


def read(run):
    return readings.host_ms_per_kread(run, "banded_align_batch")

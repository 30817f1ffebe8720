"""seed_host_ms_per_kread.map: host time inside the program's
`collect_anchors` (seeding and anchor grouping on the host, the path of a
call that holds a read over 16,384 b), summed over the map's worker
threads, in ms per thousand reads mapped."""

from core import readings


def read(run):
    return readings.host_ms_per_kread(run, "collect_anchors")

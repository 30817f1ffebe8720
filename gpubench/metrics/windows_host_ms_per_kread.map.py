"""windows_host_ms_per_kread.map: host time of the host path's window
stages, the program's spans `map.windows` (top-K, the window loop, the
window slices) and `map.extend` (padding into the batch arrays, uploads,
launches), summed over the map's worker threads, in ms per thousand reads
mapped."""

from core import readings, spans


def read(run):
    sp = spans.window(run)
    reads = readings.mapped_reads(run)
    if not sp or not reads or not spans.named(sp, "map.windows"):
        return None
    return 1e6 * spans.seconds(sp, "map.windows", "map.extend") / reads

"""fetch_wait_ms_per_kread.map: host time in the program's `map.fetch`
spans (every blocking copy of device results to the host: chain rows,
extension scores, fused rows), the host waiting for the device, summed over
the map's worker threads, in ms per thousand reads mapped."""

from core import readings, spans


def read(run):
    sp = spans.window(run)
    reads = readings.mapped_reads(run)
    if not sp or not reads or not spans.named(sp, "map.fetch"):
        return None
    return 1e6 * spans.seconds(sp, "map.fetch") / reads

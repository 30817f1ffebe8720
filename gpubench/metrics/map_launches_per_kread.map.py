"""map_launches_per_kread.map: device kernels in the traced window
(torch.profiler; copies and sets left out) per thousand reads mapped."""

from core import readings


def read(run):
    tr = run.trace
    reads = readings.mapped_reads(run)
    if tr is None or not reads or tr.n_kernels == 0:
        return None
    return 1e3 * tr.n_kernels / reads

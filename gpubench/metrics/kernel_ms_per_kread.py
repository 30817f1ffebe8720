"""kernel_ms_per_kread: the device's kernel time in the window (torch.profiler:
the union of the kernels' intervals, copies and sets left out) per thousand
reads of the requests completed in it."""

from core import readings


def read(run):
    tr = run.trace
    reads = readings.completed(run, "reads")
    if tr is None or not reads or tr.kernel_busy_s <= 0:
        return None
    return 1e6 * tr.kernel_busy_s / reads

"""device_idle_pct.amplicon: the device's idle share of the traced window
(torch.profiler: 100 - the union of kernel and copy intervals over the
window)."""

from core import readings


def read(run):
    return readings.idle_pct(run)

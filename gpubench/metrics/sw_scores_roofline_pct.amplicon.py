"""sw_scores_roofline_pct.amplicon: `sw_scores_roofline_pct.map`'s
arithmetic (`metrics/sw_scores_roofline_pct.map.py`: the least time of the
window's sw_scores calls, from the shapes the driver records in traced
runs, over the profiler's sw_scores kernel time) over the amplicon cell's
window: both maps of every sample, on 1-2 kb windows."""

from core.spec import Spec


def read(run):
    return Spec.reader("sw_scores_roofline_pct.map").read(run)

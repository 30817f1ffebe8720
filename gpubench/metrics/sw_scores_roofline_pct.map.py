"""sw_scores_roofline_pct.map: the least time of the window's sw_scores
calls (the operations and bytes their inputs need, `core.roofline`, shapes
recorded by the harness's wrapper) over the profiler's sw_scores kernel
time, in percent."""


def read(run):
    tr = run.trace
    fn = getattr(run.cell, "ext_roofline", None)
    if tr is None or fn is None:
        return None
    kernel_s = tr.kernel_s("sw_scores")
    least_s, _ = fn("sw_scores")
    if kernel_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / kernel_s

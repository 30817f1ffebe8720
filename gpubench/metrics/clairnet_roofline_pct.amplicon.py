"""clairnet_roofline_pct.amplicon: the least time of the window's model
calls on the rows they scored (the candidates, `core.clairnet_roofline`)
over the device time of the kernels launched inside the harness range
`gpubench.clairnet` around each `VariantModel.predict`, in percent."""


def read(run):
    tr = run.trace
    fn = getattr(run.cell, "clairnet_least_s", None)
    if tr is None or fn is None:
        return None
    device_s = tr.ranges.get("clairnet", 0.0)
    least_s, _ = fn()
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s

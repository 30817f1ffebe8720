"""Helpers of the metric readers (`metrics/<name>.py`)."""


def requests_of(run, kind):
    return [r for r in run.requests if r["kind"] == kind]


def completed(run, key):
    """Sum of `key` over the completed requests of every kind."""
    return sum(r.get(key, 0) for r in run.requests if r["ok"])


def rate(run, kind, key):
    """Sum of `key` over completed requests of `kind`, over the time from
    the window's start to the last completion."""
    done = [r for r in requests_of(run, kind) if r["ok"]]
    if not done or run.window_s <= 0:
        return None
    return sum(r[key] for r in done) / run.window_s


def step_total(run, step):
    """(a `.timing` step's seconds summed over samples, samples read)."""
    timings = getattr(run.cell, "timings", None)
    rows = timings() if timings is not None else []
    if not rows:
        return None, 0
    return sum(t.get(step, 0.0) for t in rows), len(rows)


def step_ms_per_read(run, step):
    total, n = step_total(run, step)
    reads = sum(r["reads"] for r in requests_of(run, "sample") if r["ok"])
    return 1e3 * total / reads if n and reads else None


def idle_pct(run):
    """100 - the device's busy union over the traced window."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.n_device_ops == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mapped_reads(run):
    return sum(r["reads"] for r in requests_of(run, "map_call") if r["ok"])


def host_ms_per_kread(run, name):
    """Host seconds the driver timed inside the program's function `name`
    (summed over calls, on whichever thread ran them), in ms per thousand
    reads mapped."""
    rec = getattr(run.cell, "host_s", {}).get(name)
    reads = mapped_reads(run)
    if not rec or not reads:
        return None
    return 1e6 * sum(rec) / reads

"""Benchmark of megapath_nano_tpu_torch: run one cell of BENCHMARK.json.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices.
Set-up builds the cell's world from its configuration and its inputs from
the seed, and warms up; then requests run one after another (a closed
loop) for `--seconds`; then the answers are judged against the plain
reference, and one JSON line is printed as the last line of stdout. With
`--trace 0` it carries the cell's end-to-end metrics, with `--trace 1` the
per-layer ones. Every run on a card records a torch.profiler trace of its
window (the end-to-end kernel time is read from it); `--trace 1` adds the
drivers' ranges and wrappers, and the device's busy time and breakdown.

Exit codes: 0 with a result; 2 without enough CUDA devices; 3 when JAX or
the JAX package was loaded; 1 on any other failure (no result then).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
os.environ["USE_FLAX"] = "0"
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "megapath_nano_tpu")


@dataclass
class Ctx:
    config: dict
    traffic: dict
    seed: int
    device: object
    trace: bool
    cache_dir: str = CACHE


@dataclass
class Run:
    """What a metric reader reads."""

    workload: str
    cell: object
    requests: list
    window_s: float
    setup_s: float
    trace: object = None


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_record(device, chips: int, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def execute(spec, workload: dict, config: dict, traffic: dict, seed: int,
            seconds: float, traced: bool, device, t0: float,
            cache_dir: str = CACHE) -> dict:
    """Set up, measure, judge. Returns the result object (every key)."""
    import torch

    from core.roofline import power_limit_w
    from core.trace import Tracer

    device = torch.device(device)
    ctx = Ctx(config=config, traffic=traffic, seed=seed, device=device,
              trace=traced, cache_dir=cache_dir)
    cell = spec.driver(traffic["driver"]).setup(ctx)
    # the end-to-end kernel time reads the card's trace, so every run on a
    # card traces; an untraced run elsewhere has no kernels to read
    tracer = Tracer(device) if traced or device.type == "cuda" else None
    if tracer is not None:
        tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    if hasattr(cell, "start_window"):
        cell.start_window()
    requests = []
    with tracer.window() if tracer is not None else nullcontext():
        w0 = time.perf_counter()
        while not requests or time.perf_counter() - w0 < seconds:
            try:
                rec = cell.request()
            except Exception:
                traceback.print_exc()
                rec = {"kind": "failed", "ok": False}
            rec["t_end"] = time.perf_counter() - w0
            requests.append(rec)
    window_s = requests[-1]["t_end"]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    cell.close_program()
    numbers = cell.check()
    run = Run(workload=workload["name"], cell=cell, requests=requests,
              window_s=window_s, setup_s=setup_s,
              trace=tracer.trace if tracer is not None else None)
    metrics = {}
    for m in spec.metrics_for(workload["name"], traced):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cell.cleanup()
    failed = sum(1 for r in requests if not r["ok"])
    limits = traffic["limits"]
    checks = {name: {"value": float(numbers[name]), "limit": float(limit)}
              for name, limit in limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = device_record(device, workload["chips"], peak)
    result = {"correct": correct, "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        tr = tracer.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
        notes = {"power_limit": power_limit_w()}
        if hasattr(cell, "notes"):
            notes.update(cell.notes(run))
        result["notes"] = notes
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    stderr; the result as the last line of stdout."""
    log, out = sys.stderr, sys.stdout
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    log.flush()
    print(json.dumps(result), file=out)
    out.flush()


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from core.spec import Spec

    spec = Spec.load(ROOT)
    workload = spec.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(spec, workload, spec.config(workload["config"]),
                     spec.traffic(workload["traffic"]), args.seed,
                     args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

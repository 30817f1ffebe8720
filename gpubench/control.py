"""Readings that set the limits of a cell's correctness check.

    python3 gpubench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--out control_<name>.jsonl]

In one process (set-up once, then per seed new inputs on the same world):
a window of the cell's own load, then the cell's numbers for the program
(the lower readings), for the control and for the planted faults (the
upper readings), one JSON line a seed. The benchmark's own runs never run
this; it needs the cell's CUDA devices.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (sets the cache directories and sys.path)


def readings(cell, seconds: float) -> dict:
    requests = []
    w0 = time.perf_counter()
    while not requests or time.perf_counter() - w0 < seconds:
        requests.append(cell.request())
    out = {"attempted": len(requests),
           "failed": sum(1 for r in requests if not r["ok"]),
           "window_s": time.perf_counter() - w0,
           "program": cell.check()}
    out.update(cell.control_readings())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from core.spec import Spec

    spec = Spec.load(run.ROOT)
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    traffic = spec.traffic(wl["traffic"])
    ctx = run.Ctx(config=spec.config(wl["config"]), traffic=traffic,
                  seed=seeds[0], device=torch.device("cuda"),
                  trace=False)
    cell = spec.driver(traffic["driver"]).setup(ctx)
    print(f"set-up {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(seeds):
            if i:
                cell.reseed(seed)
            rec = {"workload": args.workload, "seed": seed}
            rec.update(readings(cell, args.seconds))
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        cell.cleanup()
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

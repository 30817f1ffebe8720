"""Find a workload's files by the names in BENCHMARK.json.

- configuration: `configs/<config>.json` (the path in its `file` entry);
- traffic mix: `traffic/<traffic>.json`, which names its driver;
- driver: `drivers/<driver>.py`, with `setup(ctx)`;
- metric reader: `metrics/<metric name>.py`, with `read(run)`.

A later cell or metric is new files and new entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, bench: dict, root: str):
        self.bench = bench
        self.root = root

    @staticmethod
    def load(root: str) -> "Spec":
        return Spec(read_json(os.path.join(root, "BENCHMARK.json")), root)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return read_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        return read_json(os.path.join(HERE, "traffic", f"{name}.json"))

    @staticmethod
    def driver(name: str):
        return load_module(os.path.join(HERE, "drivers", f"{name}.py"),
                           f"gpubench_driver_{name}")

    @staticmethod
    def reader(metric: str):
        return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                           "gpubench_metric_" + metric.replace(".", "_"))

    def metrics_for(self, workload: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer ones."""
        group = self.bench["per_layer"] if traced else self.bench["end_to_end"]
        return [m for m in group
                if "workloads" not in m or workload in m["workloads"]]

"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, a
configuration's file, a traffic mix's file and a metric's reader, each
found by its name."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of BENCHMARK.json with what it names: the
    configuration (``benchmark/configs/<config>.json``), the traffic mix
    (``benchmark/traffic/<traffic>.json``) and its metrics."""

    def __init__(self, bench: dict, name: str, bench_dir: str = BENCH_DIR):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.bench_dir = bench_dir
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = load_json(os.path.join(
            os.path.dirname(bench_dir), self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))

        def mine(m):
            return name in m.get("workloads", (name,))
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

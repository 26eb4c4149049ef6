"""The benchmark's data: `BENCHMARK.json` at the root of the checkout and
the files under `h100_bench/`, found by the names it gives.

- `configs/<config>.json`: one model configuration (sizes, precision).
- `traffic/<traffic>.json`: one traffic mix, the parameters that the
  driver it names (`drivers/<driver>.py`) and `workgen.py` read.
- `workloads/<cell>.json`: a cell's correctness limits and sample sizes.
- `metrics/<metric>.py`: one reader per per-layer metric, `read(run)`.

Nothing here names a cell, a configuration or a metric: a later one is
added as files and entries, and this module finds it.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """`BENCHMARK.json` and the benchmark's files, rooted at `root` (the
    checkout; tests point it at a copy)."""

    def __init__(self, root: Optional[str] = None,
                 bench_dir: Optional[str] = None):
        self.bench_dir = bench_dir or BENCH_DIR
        self.root = root or os.path.dirname(self.bench_dir)
        self.manifest = _load_json(os.path.join(self.root, "BENCHMARK.json"))

    # -- lookups by name ------------------------------------------------

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(self.cell_names())})")

    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.manifest["workloads"]]

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                cfg = _load_json(os.path.join(self.root, c["file"]))
                cfg.setdefault("name", name)
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench_dir, "traffic",
                                       f"{name}.json"))

    def cell_file(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench_dir, "workloads",
                                       f"{name}.json"))

    # -- which metrics a cell reports -------------------------------------

    @staticmethod
    def _in(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        """The cell's end-to-end metrics: those that list it, and those
        that list no cells (`setup_s`)."""
        return [m for m in self.manifest["end_to_end"] if self._in(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        """The cell's per-layer metrics: those that list it, and those
        that list no cells and move an end-to-end metric the cell
        reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable:
        """`read(run) -> float | None` of `metrics/<metric>.py`."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        mod_name = "h100_bench_metric_" + "".join(
            ch if ch.isalnum() else "_" for ch in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix. The
harness reads:

- the configuration's file, from its `configs` entry;
- `traffic/<traffic>.json`, whose `kind` names the generator module
  `kinds/<kind>.py` that drives the cell;
- `checks/<cell>.json`, the limits of the comparison that decides
  `correct`, with the readings they were set from;
- `metrics/<metric>.py` for every metric the cell reports, each with one
  `read(run) -> float | None`.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType

#: the folder that holds the benchmark (this file's parent's parent)
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str) -> ModuleType:
    """A module from its file; names may hold dots, so no import path."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    entry: dict
    config: dict
    config_entry: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    run_seconds: int

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def kind_module(self) -> ModuleType:
        return _load_module(os.path.join(BENCH_DIR, "kinds", f"{self.kind}.py"),
                            f"bench_kind_{self.kind}")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: with trace off its end-to-end
        metrics (one without `workloads` in every cell), with trace on the
        per-layer metrics whose `workloads` name it."""
        if not trace:
            return [m for m in self.end_to_end
                    if self.name in m.get("workloads", [self.name])]
        return [m for m in self.per_layer if self.name in m["workloads"]]


def reader(metric_name: str) -> ModuleType:
    """metrics/<name>.py, the one reader of a metric."""
    return _load_module(os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py"),
                        f"bench_metric_{metric_name.replace('.', '_')}")


def load_cell(root: str, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json and its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        names = [w["name"] for w in bench["workloads"]]
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json {names}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload, entry=entry,
        config=_load_json(os.path.join(root, cfg_entry["file"])),
        config_entry=cfg_entry,
        traffic=_load_json(os.path.join(BENCH_DIR, "traffic",
                                        f"{entry['traffic']}.json")),
        check=_load_json(os.path.join(BENCH_DIR, "checks", f"{workload}.json")),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
        run_seconds=int(bench["run_seconds"]))

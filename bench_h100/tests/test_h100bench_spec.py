"""BENCHMARK.json and the files it names: every name finds its file, and
the file keeps to the contract's form."""

from __future__ import annotations

import json
import os
import re

from conftest import REPO

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_loads_its_files_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(REPO, w["name"])
        assert cell.config_entry["name"] == w["config"]
        assert hasattr(cell.kind_module(), "run")
        assert cell.check["limits"]
        for trace in (False, True):
            names = [m["name"] for m in cell.metrics(trace)]
            assert names, (w["name"], trace)
            for name in names:
                assert callable(spec.reader(name).read)
        e2e = [m["name"] for m in cell.metrics(False)]
        assert "setup_s" in e2e and len(e2e) >= 2, e2e


def test_benchmark_keeps_to_the_contract_form():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    # a full check of 24 cells fits the driver's 43200 seconds
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_metric_files_hold_one_reader_each():
    bench = _bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert mod.read({}) is None, m["name"]  # nothing to read: nothing


def test_the_set_aside_chat_cell_still_finds_its_files():
    """The chat cell left out of BENCHMARK.json (parked/) keeps to the
    form, so that a later benchmark can take its entries back as they are."""
    with open(os.path.join(REPO, "bench_h100", "parked",
                           "phi3-mini.chat.json")) as f:
        parked = json.load(f)
    (cfg,), (cell,) = parked["configs"], parked["workloads"]
    assert os.path.isfile(os.path.join(REPO, cfg["file"]))
    assert cell["config"] == cfg["name"]
    for rel in (f"traffic/{cell['traffic']}.json",
                f"checks/{cell['name']}.json"):
        assert os.path.isfile(os.path.join(REPO, "bench_h100", rel)), rel
    e2e = {m["name"] for m in parked["end_to_end"]}
    for m in parked["end_to_end"] + parked["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["workloads"] == [cell["name"]]
        assert spec.reader(m["name"]).read({}) is None
    assert all(m["moves"] in e2e for m in parked["per_layer"])

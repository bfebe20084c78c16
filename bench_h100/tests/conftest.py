"""Fixtures of the benchmark's CPU tests: a checkout holding a copy of the
benchmark plus tiny cells defined by new files and entries alone, and a
runner of one cell in a fresh process with the port's plain CPU paths."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

TINY_LLM = {"run": {"vocab_size": 512, "d_model": 64, "n_layers": 2,
                    "n_heads": 4, "max_seq": 256, "rope_theta": 10000.0,
                    "dtype": "bfloat16"},
            "deployment": {"max_batch": 4, "decode_chunk": 4,
                           "max_ongoing_requests": 8, "num_cpus": 2,
                           "deploy_timeout_s": 120}}
TINY_TRAIN = {"run": {"vocab_size": 512, "d_model": 64, "n_layers": 2,
                      "n_heads": 4, "n_kv_heads": 2, "d_ff": 160,
                      "max_seq": 64, "rope_theta": 10000.0,
                      "compute_dtype": "bfloat16",
                      "param_dtype": "float32"}}
TINY_CHAT_MIX = {"kind": "closed_loop", "clients": 4,
                 "prompt_tokens": {"low": 16, "high": 64},
                 "output_tokens": {"low": 8, "high": 24}, "greedy_every": 2,
                 "sampling": {"temperature": 0.7, "top_p": 0.9},
                 "warm_prompt_tokens": [16, 32, 64], "warm_output_tokens": 5,
                 "ramp_s": 1, "drain_s": 20, "profile_s": 1,
                 "check_requests": 2}
TINY_TRAIN_MIX = {"kind": "train_batches", "batch": 2, "seq_len": 32,
                  "lr": 0.001, "pool": 4, "check_steps": 3,
                  "profile_steps": 2, "optimizer_reps": 3}
# The tiny cells' limits, from readings on the CPU (test_h100bench_faults.py
# prints them; seeds 3, 4): the program's loss, grad and change read at most
# 4.0e-5, 4.4e-3 and 2.3e-3, the float8 control's 1.7e-4, 2.3e-2 and 8.9e-3
# at the least, half of the batch left out 2.0e-3, 0.49 and 0.030; the
# greedy gap (seeds 5, 6) at most 2.6e-3, the control's 3.7e-2 at the least.
TINY_CHAT_CHECK = {"limits": {"greedy_gap": {"max": 0.02},
                              "unanswered": {"max": 0},
                              "judged_tokens": {"min": 10}}}
TINY_TRAIN_CHECK = {"limits": {"loss": {"max": 1e-4},
                               "grad": {"max": 0.012},
                               "change": {"max": 0.006}}}


def add_cell(root: str, name: str, config: str, config_doc: dict,
             traffic: str, traffic_doc: dict, check_doc: dict,
             metrics: bool = True) -> None:
    """Add a cell to the checkout at `root` by new files and entries: its
    configuration, mix and limits, one `configs` and one `workloads` entry,
    and (with `metrics`) the metrics of its kind: the training cell's, or
    for a serving cell those of the set-aside chat cell (`parked/`)."""
    b = os.path.join(root, "bench_h100")
    files = {f"configs/{config}.json": config_doc,
             f"traffic/{traffic}.json": traffic_doc,
             f"checks/{name}.json": check_doc}
    for rel, doc in files.items():
        path = os.path.join(b, rel)
        assert not os.path.exists(path), f"{rel} is not new"
        with open(path, "w") as f:
            json.dump(doc, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": config, "source": "https://example.org/tiny",
        "file": f"bench_h100/configs/{config}.json", "reduced": [],
        "why": "a tiny model for the CPU tests"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a tiny cell for the CPU tests"})
    if metrics and traffic_doc["kind"] == "closed_loop":
        # the serving metrics, as the set-aside chat cell lists them
        with open(os.path.join(BENCH, "parked", "phi3-mini.chat.json")) as f:
            parked = json.load(f)
        for key in ("end_to_end", "per_layer"):
            for m in parked[key]:
                bench[key].append(dict(m, workloads=[name]))
    elif metrics:
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "phi3-medium.train" in m.get("workloads", []):
                m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding BENCHMARK.json and a copy of the benchmark, with
    the tiny cells `tiny.chat` and `tiny.train` added."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_cell(root, "tiny.chat", "tiny-llm", TINY_LLM, "tiny_chat",
             TINY_CHAT_MIX, TINY_CHAT_CHECK)
    add_cell(root, "tiny.train", "tiny-train", TINY_TRAIN, "tiny_train",
             TINY_TRAIN_MIX, TINY_TRAIN_CHECK)
    return root


def run_cell(root: str, argv: list, *, env: dict | None = None,
             device: str = "cpu", port: bool = True,
             timeout: float = 300) -> subprocess.CompletedProcess:
    """Run bench_h100/run.py's main in a fresh process from `root`, on
    `device` (the CPU skips the look for a card), with the port importable
    when `port`."""
    code = ("import sys; sys.path.insert(0, 'bench_h100'); import run; "
            f"sys.exit(run.main({argv!r}, device={device!r}))")
    full = dict(os.environ)
    full["PYTHONPATH"] = REPO if port else ""
    full["TMPDIR"] = os.path.join(root, "tmp")
    os.makedirs(full["TMPDIR"], exist_ok=True)
    full.update(env or {})
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=full,
                          capture_output=True, text=True, timeout=timeout)


def result(proc: subprocess.CompletedProcess) -> dict:
    """The contract's line: the last line of standard output."""
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])

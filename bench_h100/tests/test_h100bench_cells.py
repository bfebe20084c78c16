"""Whole runs of tiny cells on the CPU, through the port's plain attention
path: the contract's line, a cell added by new files and one entry alone,
and the runs the benchmark must refuse."""

from __future__ import annotations

import json
import os
import shutil

from conftest import (BENCH, REPO, TINY_CHAT_CHECK, TINY_CHAT_MIX, TINY_LLM,
                      add_cell, result, run_cell)

from harness import guards

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _check_line(line: dict, trace: bool):
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "check", keys
    assert ("breakdown" in keys) == trace
    for c in line["check"].values():
        assert c["value"] is not None and ("max" in c or "min" in c)


def test_a_cell_added_by_new_files_and_one_entry_runs(tmp_path):
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_cell(root, "newcell.chat", "newcell-llm", TINY_LLM, "newcell_chat",
             TINY_CHAT_MIX, TINY_CHAT_CHECK, metrics=False)
    line = result(run_cell(root, ["--workload", "newcell.chat", "--seed",
                                  str(2**31 + 3), "--seconds", "3",
                                  "--trace", "0"]))
    _check_line(line, trace=False)
    assert line["correct"] is True
    assert list(line["metrics"]) == ["setup_s"]  # the metric of every cell


def test_tiny_chat_reports_its_metrics(tiny_root):
    proc = run_cell(tiny_root, ["--workload", "tiny.chat", "--seed",
                                str(2**31 + 11), "--seconds", "3",
                                "--trace", "0"])
    line = result(proc)
    _check_line(line, trace=False)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"output_tokens_per_s", "setup_s"}
    assert line["attempted"] > 10
    # the compared numbers are the last lines of standard error
    tail = proc.stderr.strip().splitlines()[-3:]
    assert [t.split(":")[0] for t in tail] == [
        f"check {n}" for n in line["check"]]


def test_tiny_chat_traced_reads_the_replica_profile(tiny_root):
    line = result(run_cell(tiny_root, ["--workload", "tiny.chat", "--seed",
                                       "5", "--seconds", "4", "--trace",
                                       "1"]))
    _check_line(line, trace=True)
    assert line["correct"] is True
    # the CPU runs no kernel: the kernel's metric finds nothing to read
    assert set(line["metrics"]) == {"engine.decode_step_ms",
                                    "engine.slot_fill", "ttft_p90_ms.chat",
                                    "tpot_p90_ms.chat", "ttft_p50_ms",
                                    "mfu.chat", "device.idle_share.chat"}
    assert line["device"]["window_s"] > 0.5


def test_tiny_train_runs_traced_and_untraced(tiny_root):
    for trace in (0, 1):
        line = result(run_cell(tiny_root, ["--workload", "tiny.train",
                                           "--seed", str(2**31 + 21),
                                           "--seconds", "2", "--trace",
                                           str(trace)]))
        _check_line(line, trace=bool(trace))
        assert line["correct"] is True
        want = ({"mfu.train", "device.idle_share.train"} if trace
                else {"train_tokens_per_s", "setup_s"})
        assert set(line["metrics"]) == want


def test_no_card_no_result(tiny_root):
    proc = run_cell(tiny_root, ["--workload", "tiny.train", "--seed", "1",
                                "--seconds", "1"], device="cuda")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_without_the_port_no_result(tiny_root):
    proc = run_cell(tiny_root, ["--workload", "tiny.train", "--seed", "1",
                                "--seconds", "1"], port=False)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "ray_tpu_torch" in proc.stderr


def test_a_run_that_loads_jax_prints_no_result(tiny_root, tmp_path):
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    (fake / "sitecustomize.py").write_text("import jax\n")
    proc = run_cell(tiny_root, ["--workload", "tiny.train", "--seed", "1",
                                "--seconds", "1"],
                    env={"PYTHONPATH": f"{fake}{os.pathsep}{REPO}"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "['jax']" in proc.stderr


def test_forbidden_names_compare_whole():
    mods = {"ray_tpu_torch": 1, "ray_tpu_torch.llm": 1, "jaxtyping": 1,
            "numpy": 1}
    assert guards.forbidden_modules(mods) == []
    mods.update({"ray_tpu.llm": 1, "jax.numpy": 1, "optax": 1})
    assert guards.forbidden_modules(mods) == ["jax.numpy", "optax",
                                              "ray_tpu.llm"]


def test_the_line_is_json_with_numbers_only(tiny_root):
    line = result(run_cell(tiny_root, ["--workload", "tiny.train", "--seed",
                                       "9", "--seconds", "1"]))
    json.dumps(line, allow_nan=False)

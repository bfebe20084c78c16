"""On the card, at the cells' own sizes: every cell of BENCHMARK.json runs
correct, and its control (the reference in float8 in the program's place)
fails the cell's limits. Minutes a cell; on the card run

    python -m pytest -p no:cacheprovider bench_h100/tests/test_h100bench_cuda.py -m cuda
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' programs run CUDA "
                    "kernels that have no CPU mode")


def _cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_cell_runs_correct(card, workload):
    proc = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", workload,
         "--seed", str(2**31 + 101), "--seconds", "10", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]


@pytest.mark.parametrize("workload", _cells())
def test_control_fails_the_cell(card, workload):
    seed = str(2**31 + 103)
    proc = subprocess.run(
        [sys.executable, "bench_h100/calibrate.py", "--workload", workload,
         "--seeds", seed, "--control-seeds", seed, "--seconds", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(REPO, "bench_h100", "checks",
                           f"{workload}.json")) as f:
        limits = json.load(f)["limits"]
    failed = [k for k, v in row["control"].items() if k in limits
              and "max" in limits[k] and v > limits[k]["max"]]
    assert failed, (row["control"], limits)

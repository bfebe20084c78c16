"""`correct` comes out false when the timed path is broken underneath,
once for each fault the cell can have, and the control (the reference in
float8 in the program's place) reads more than the program.

The runs skip the look for a card and run the rest on the CPU at tiny
sizes; the faults are planted in the measured program's process (the
serve replica's for a served token) by tests/fault_site/sitecustomize.py.
On the card, at the cells' own sizes, `calibrate.py` reads the control
and the faults and judges each through `run.judge`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, result, run_cell

FAULT_SITE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fault_site")


def _faulty(root, workload, fault, seconds="3"):
    env = {"PYTHONPATH": f"{FAULT_SITE}{os.pathsep}{REPO}",
           "BENCH_H100_FAULT": fault}
    return result(run_cell(root, ["--workload", workload, "--seed",
                                  str(2**31 + 41), "--seconds", seconds],
                           env=env))


def test_a_token_altered_where_it_is_produced_fails(tiny_root):
    line = _faulty(tiny_root, "tiny.chat", "token")
    assert line["correct"] is False
    gap = line["check"]["greedy_gap"]
    assert gap["value"] > gap["max"]


@pytest.mark.parametrize("fault,number", [("frozen_step", "change"),
                                          ("half_batch", "grad")])
def test_a_broken_training_step_fails(tiny_root, fault, number):
    line = _faulty(tiny_root, "tiny.train", fault, seconds="1")
    assert line["correct"] is False
    c = line["check"][number]
    assert c["value"] > c["max"], line["check"]


def _calibrate(root, workload, seeds):
    code = ("import sys; sys.path.insert(0, 'bench_h100'); import calibrate; "
            f"sys.exit(calibrate.main(['--workload', {workload!r}, '--seeds', "
            f"{seeds!r}, '--control-seeds', {seeds!r}, '--seconds', '2'], "
            "device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=os.path.join(root, "tmp"))
    os.makedirs(env["TMPDIR"], exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    print(json.dumps(rows, indent=1))
    return rows


def test_the_control_reads_more_than_the_program(tiny_root):
    with open(os.path.join(tiny_root, "bench_h100", "checks",
                           "tiny.train.json")) as f:
        limits = json.load(f)["limits"]
    for row in _calibrate(tiny_root, "tiny.train", "3,4"):
        prog, ctl = row["program"], row["control"]
        assert all(prog[k] <= limits[k]["max"] for k in limits), prog
        assert any(ctl[k] > limits[k]["max"] for k in limits), ctl
        half = row["faults"]["half_batch"]
        assert any(half[k] > limits[k]["max"] for k in limits), half
        # the same verdicts through the comparison that decides `correct`
        assert row["correct"] == {"program": True, "control": False,
                                  "half_batch": False,
                                  "frozen_step": False}, row
    with open(os.path.join(tiny_root, "bench_h100", "checks",
                           "tiny.chat.json")) as f:
        gap = json.load(f)["limits"]["greedy_gap"]["max"]
    for row in _calibrate(tiny_root, "tiny.chat", "5,6"):
        assert row["program"]["greedy_gap"] <= gap
        assert row["control"]["greedy_gap"] > gap, row
        assert row["correct"] == {"program": True, "control": False}, row

"""The port's `ray-tpu-torch` CLI on the CPU: start/status/stop, jobs, top,
profile, timeline, stalls and lint.

Counterpart tests: tests/test_cli.py (both tests),
tests/test_telemetry.py::test_profile_worker_cpu_end_to_end and
::test_top_once_renders, tests/test_tracing.py::
test_timeline_cli_exports_perfetto_json and tests/test_chaos_stall.py::
test_stalls_cli_lists_reports, run on `ray_tpu_torch`. Beside them:
`profile --mode torch` persists a zip holding a Chrome `trace.json`,
`start --num-gpus 1` advertises one GPU in `status` and leaves no process
of its session after `stop`, and `lint` with no paths checks the port.
Session dirs live under tmp_path; every CLI call and `get` has a timeout.
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import urllib.request
import zipfile

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.scripts.cli import main as cli_main
from ray_tpu_torch.util import state

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (phase 14's session checks)


def _cli(session_dir, *args, timeout=120, env=None):
    full = dict(os.environ)
    full["PYTHONPATH"] = str(REPO) + os.pathsep + full.get("PYTHONPATH", "")
    full.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
         "--session-dir", str(session_dir), *args],
        capture_output=True, text=True, timeout=timeout, env=full)


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(0.2)
    raise TimeoutError(f"timed out waiting for {what}")


def _address() -> str:
    from ray_tpu_torch._private.worker import global_worker

    host, port = global_worker().controller_addr
    return f"{host}:{port}"


@pytest.fixture
def shutdown_only():
    yield
    rt.shutdown()


# ---- tests/test_cli.py
def test_cli_cluster_lifecycle(tmp_path, shutdown_only):
    sdir = tmp_path / "session"
    try:
        r = _cli(sdir, "start", "--head", "--num-cpus", "1", "--port", "0")
        assert r.returncode == 0, r.stderr
        info = json.load(open(sdir / "head.json"))

        r = _cli(sdir, "start", "--address", info["address"], "--num-cpus",
                 "2")
        assert r.returncode == 0, r.stderr

        r = _cli(sdir, "status")
        assert r.returncode == 0, r.stderr
        assert r.stdout.count("ALIVE") == 2, r.stdout

        # A driver connects and runs work on BOTH CLI-started nodes.
        rt.init(address=info["address"])

        @rt.remote(scheduling_strategy="SPREAD")
        def where():
            return os.environ.get("RT_NODE_ID")

        nodes = set(rt.get([where.remote() for _ in range(6)], timeout=120))
        assert len(nodes) == 2
        rt.shutdown()
    finally:
        r = _cli(sdir, "stop")
    assert "stopped" in r.stdout
    assert not (sdir / "head.json").exists()


def test_cli_job_workflow(tmp_path):
    """ray-tpu-torch job submit/status/logs/list against a CLI-started
    head."""
    sdir = tmp_path / "session"
    try:
        r = _cli(sdir, "start", "--head", "--num-cpus", "1", "--port", "0")
        assert r.returncode == 0, r.stderr

        r = _cli(sdir, "job", "submit", "--submission-id", "jobA", "--",
                 "python", "-c", "print(6 * 7)")
        assert r.returncode == 0, r.stderr + r.stdout
        assert "42" in r.stdout and "SUCCEEDED" in r.stdout, r.stdout

        r = _cli(sdir, "job", "status", "jobA")
        assert r.stdout.strip() == "SUCCEEDED", r.stdout

        r = _cli(sdir, "job", "logs", "jobA")
        assert "42" in r.stdout

        r = _cli(sdir, "job", "list")
        assert "jobA" in r.stdout and "SUCCEEDED" in r.stdout
    finally:
        _cli(sdir, "stop")


def test_cli_gpu_node_and_clean_stop(tmp_path):
    """A head with 0 GPUs and a node started with --num-gpus 1: status
    counts one GPU in total, on the joined node, and `stop` leaves no
    process and no /dev/shm segment of the session."""
    sdir = tmp_path / "session"
    try:
        r = _cli(sdir, "start", "--head", "--num-cpus", "1", "--num-gpus",
                 "0", "--port", "0")
        assert r.returncode == 0, r.stderr
        info = json.load(open(sdir / "head.json"))
        r = _cli(sdir, "start", "--address", info["address"], "--num-cpus",
                 "1", "--num-gpus", "1")
        assert r.returncode == 0, r.stderr
        r = _cli(sdir, "status")
        assert r.returncode == 0, r.stderr
        rows = [line for line in r.stdout.splitlines() if "ALIVE" in line]
        assert len(rows) == 2, r.stdout
        gpu_rows = [line for line in rows if "'GPU': 1.0" in line]
        node = json.load(open(sdir / "nodes.json"))[0]["node_id"]
        assert len(gpu_rows) == 1 and node[:8] in gpu_rows[0], r.stdout
        assert r.stdout.count("'GPU'") == 2  # its total and its available
    finally:
        r = _cli(sdir, "stop")
    assert "stopped 2 process(es)" in r.stdout, r.stdout
    assert not (sdir / "head.json").exists()
    _wait(lambda: not chip_smoke._session_pids(info["session"]), 30,
          "the session's processes to exit")
    assert not chip_smoke._session_segments(info["session"])


# ---- tests/test_telemetry.py
def test_profile_worker_cpu_end_to_end(shutdown_only):
    """`profile_worker` on a busy worker: non-empty collapsed stacks
    naming the hot method, persisted under <session>/profiles/, listed in
    the registry, and fetchable through /api/profiles."""
    rt.init(num_cpus=2)

    @rt.remote
    class Busy:
        def spin(self, seconds):
            t0 = time.time()
            x = 0
            while time.time() - t0 < seconds:
                x += 1
            return x

    a = Busy.remote()
    ref = a.spin.remote(8.0)
    time.sleep(0.5)  # the call is executing
    w = rt._private.worker.global_worker()
    info = w.io.run(w.controller.call(
        "get_actor_info", actor_id=a._actor_id, wait=True), timeout=30)
    rep = w.io.run(w.controller.call(
        "profile_worker", worker_id=info["worker_id"], seconds=1.0,
        mode="cpu"), timeout=45)
    assert rep.get("found"), rep
    meta = rep["profile"]
    assert meta["samples"] > 10, meta
    assert "/profiles/" in meta["path"]
    assert os.path.exists(meta["path"]), meta["path"]

    rows = state.list_profiles()
    assert any(r["name"] == meta["name"] for r in rows)

    doc = w.io.run(w.controller.call("get_profile", name=meta["name"]),
                   timeout=30)
    assert doc["found"]
    collapsed = doc["collapsed"]
    assert collapsed, "collapsed stacks empty"
    assert any("spin" in stack for stack in collapsed), list(collapsed)[:3]
    assert doc["traceEvents"], "chrome-trace events missing"
    assert any(ev.get("ph") == "X" and "spin" in ev.get("name", "")
               for ev in doc["traceEvents"])

    # prefix fetch + dashboard surface
    from ray_tpu_torch.dashboard import start_dashboard

    d = start_dashboard(port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.port}/api/profiles", timeout=10) as r:
            listing = json.loads(r.read())
        assert any(p["name"] == meta["name"] for p in listing["profiles"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.port}/api/profiles?"
                f"name={meta['name'][:10]}", timeout=10) as r:
            fetched = json.loads(r.read())
        assert fetched["found"] and fetched["collapsed"]
    finally:
        d.stop()
    assert rt.get(ref, timeout=60) > 0


def test_profile_torch_mode_persists_a_chrome_trace(shutdown_only, capsys):
    """`profile --mode torch` through the CLI: the worker's torch.profiler
    window persists as a zip archive whose trace.json is a Chrome trace,
    and -o is refused for it."""
    rt.init(num_cpus=2)

    @rt.remote
    class Matmul:
        def wid(self):
            return os.environ["RT_WORKER_ID"]

        def spin(self, seconds):
            import torch

            t0 = time.time()
            x = torch.ones(64, 64)
            while time.time() - t0 < seconds:
                x = torch.tanh(x @ x)
            return float(x.sum())

    a = Matmul.remote()
    wid = rt.get(a.wid.remote(), timeout=60)
    ref = a.spin.remote(4.0)
    out = str(pathlib.Path(tempfile.mkdtemp()) / "ignored.json")
    assert cli_main(["profile", "--address", _address(), "--worker",
                     wid[:12], "--seconds", "0.5", "--mode", "torch",
                     "-o", out]) == 0
    printed = capsys.readouterr()
    assert "(torch, " in printed.out and "trace archive" in printed.out
    assert "-o applies to cpu mode only" in printed.err
    assert not os.path.exists(out)
    archive = printed.out.split("trace archive:")[1].split()[0]
    with zipfile.ZipFile(archive) as z:
        trace = json.loads(z.read("trace.json"))
    assert isinstance(trace["traceEvents"], list)
    assert any(r["mode"] == "torch" and r["worker_id"] == wid
               for r in state.list_profiles())
    assert rt.get(ref, timeout=60) > 0


def test_top_once_renders(monkeypatch, shutdown_only, capsys):
    monkeypatch.setenv("RT_TELEMETRY_INTERVAL_S", "0.2")
    rt.init(num_cpus=2)

    @rt.remote
    def one():
        return 1

    rt.get([one.remote() for _ in range(3)], timeout=60)
    _wait(lambda: any(r["series"] == "node.cpu" for r in state.timeseries()),
          20, "a node sample")
    assert cli_main(["top", "--once", "--address", _address()]) == 0
    out = capsys.readouterr().out
    assert "NODE" in out and "CPU%" in out and "GPU MEM USED/PEAK" in out
    assert "ALIVE" in out, out
    assert "controller:" in out and "loop_lag" in out
    assert "telemetry idle" not in out
    # No worker touched CUDA: the memory and compile columns print "-".
    row = next(line for line in out.splitlines() if "ALIVE" in line)
    cols = row.split()
    assert cols[5] == "-" and cols[6] == "-", row


# ---- tests/test_tracing.py
def test_timeline_cli_exports_perfetto_json(monkeypatch, shutdown_only,
                                            tmp_path):
    """`ray-tpu-torch timeline -o` emits catapult-shaped JSON Perfetto
    accepts: a traceEvents list of complete "X" events (plus "M"
    metadata) with numeric, monotonically non-decreasing timestamps."""
    monkeypatch.setenv("RT_TRACING", "1")
    rt.init(num_cpus=1)

    @rt.remote
    def traced_fn(x):
        return x * 2

    assert rt.get(traced_fn.remote(21), timeout=60) == 42
    # The worker's execute/result spans ride a later flush tick than the
    # driver's submit span: wait for what the export needs (>= 3 spans).
    _wait(lambda: any(r["spans"] >= 3 for r in state.list_traces()),
          30, "traces indexed controller-side")

    out = str(tmp_path / "trace.json")
    assert cli_main(["timeline", "--address", _address(), "-o", out]) == 0
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs
    assert doc.get("displayTimeUnit") == "ms"
    last_ts = -1.0
    seen_x = 0
    for e in evs:
        assert e["ph"] in ("X", "M"), f"unexpected event phase: {e}"
        assert isinstance(e["pid"], int)
        if e["ph"] == "X":
            seen_x += 1
            assert isinstance(e["ts"], (int, float))
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 1.0
            assert e["ts"] >= last_ts, "timestamps must be monotonic"
            last_ts = e["ts"]
            assert e["name"] and "cat" in e and "tid" in e
    assert seen_x >= 3  # at least submit/dispatch-or-result/execute

    # --trace with a unique prefix selects one trace.
    tid = state.list_traces()[-1]["trace_id"]
    out2 = str(tmp_path / "one.json")
    assert cli_main(["timeline", "--address", _address(), "--trace",
                     tid[:12], "-o", out2]) == 0
    doc2 = json.load(open(out2))
    assert all((e["args"].get("trace_id") == tid)
               for e in doc2["traceEvents"] if e["ph"] == "X")


# ---- tests/test_chaos_stall.py
@rt.remote(max_retries=2)
def stalls_on_first_attempt(path):
    import os
    import time as _t

    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))
    if n == 0:
        _t.sleep(120)  # silent stall: alive, socket open, no progress
    return n + 1


def test_stalls_cli_lists_reports(shutdown_only, tmp_path, capsys):
    rt.init(num_cpus=1, _system_config={
        "stall_warn_s": 0.4, "stall_kill_s": 1.2,
        "stall_beacon_interval_s": 0.1,
    })
    marker = str(tmp_path / "attempts")
    assert rt.get(stalls_on_first_attempt.remote(marker), timeout=60) == 2
    assert cli_main(["stalls", "--address", _address(), "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "warn" in out and "kill" in out, out


# ---- lint
#: One file per pass of `ray-tpu-torch lint` that violates that pass, at
#: a path under ray_tpu_torch/ the pass reads.
LINT_PLANTS = {
    "async-blocking": ("ray_tpu_torch/_private/plant_async.py", """
import time


async def handler():
    time.sleep(1)
"""),
    "exception-taxonomy": ("ray_tpu_torch/_private/plant_except.py", """
def swallow():
    try:
        return 1
    except:
        return 0
"""),
    "knob-registry": ("ray_tpu_torch/plant_knob.py", """
import os

VALUE = os.environ.get("RT_NOT_A_REGISTERED_KNOB")
"""),
    "event-kinds": ("ray_tpu_torch/plant_event.py", """
from ray_tpu_torch._private.events import emit_event


def report():
    emit_event("no_such_event_kind", "plant")
"""),
    "lock-discipline": ("ray_tpu_torch/plant_lock.py", """
import threading


class TwoLocks:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                pass

    def other(self):
        with self._b:
            with self._a:
                pass
"""),
    "wire-schema": ("ray_tpu_torch/plant_wire.py", """
class Record:
    def __getstate__(self):
        return (self.a, self.b, self.c)

    def __setstate__(self, state):
        self.a, self.b = state
"""),
}


def test_lint_with_no_paths_checks_the_port(capsys, tmp_path):
    """`ray-tpu-torch lint` runs rtcheck's six passes over ray_tpu_torch/
    (every .py file counted) and the tree is clean; on a scratch tree with
    the port's registry files, each pass finds the file planted to violate
    it (and the planted files are all it finds)."""
    import shutil

    from ray_tpu_torch.scripts import lint

    assert cli_main(["lint", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and not rep["findings"] and not rep["baselined"]
    n_files = sum(name.endswith(".py") for _, _, names in
                  os.walk(os.path.join(lint.REPO_ROOT, "ray_tpu_torch"))
                  for name in names)
    assert rep["files"] == n_files > 100

    for rel in (lint.REGISTRY_PATH, lint.EVENTS_PATH, *lint.TAXONOMY_FILES,
                "README.md"):
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(lint.REPO_ROOT, rel), tmp_path / rel)
    for rel, source in LINT_PLANTS.values():
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        (tmp_path / rel).write_text(source)
    res = lint.run(root=str(tmp_path))
    found = {(f.pass_id, f.path) for f in res.findings}
    assert found == {(pid, rel) for pid, (rel, _) in LINT_PLANTS.items()}, \
        [f.render() for f in res.findings]
    assert {p.id for p in lint.passes()} == set(LINT_PLANTS)

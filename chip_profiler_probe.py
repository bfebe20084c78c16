#!/usr/bin/env python3
"""What a worker's torch.profiler prep costs, on one NVIDIA GPU.

    python3 chip_profiler_probe.py

from the root of a checkout.

A process's first torch.profiler session pays CUPTI's start-up; with the
`profiler_prep` flag a worker takes that session on a thread of its own
(`telemetry.TorchProfilerPrep`) beside whatever it runs. Fresh processes,
in turns (none, prep, prep, none), each launch small kernels from the main
thread and print one JSON line:

- none: no profiler session until its last step. The host microseconds a
  launch takes (median of 5 batches of 2000 launches, synchronised), then
  two captures of 2 s (`torch_profile` with no prep: the first pays the
  start-up in its `startup_s`), then the launch cost again.
- prep: the launch cost, then the prep's session started while the main
  thread goes on launching in batches of 20 (the session's length, the
  main thread's longest gap between two batches, the launch cost during
  the session), then the launch cost after it (beside none's, the cost
  CUPTI leaves behind), then two captures through the prep and the launch
  cost after them.

    python3 chip_profiler_probe.py --captures

counts the CUDA kernel events of a capture made after a process's first
session, with a thread launching small kernels throughout, in fresh
processes: the first session (empty, as the prep's) and the 1 s capture
run on two threads ("cross", as a worker runs the prep and a capture) or
on one ("same"); the capture is asked for 1, 4 or 20 s after the first
session starts (during or after it). First four processes at a time, then
one at a time. One JSON line a process: the variant, the delay, the first
session's seconds, the capture's wait and its kernel events.

    python3 chip_profiler_probe.py --ops

builds the kernels, runs chip_smoke.py's phase 4 for its lone answer and
then phase 14 four times in turns, with the prep armed cluster-wide
(RT_PROFILER_PREP=1 in the cluster's environment, so every GPU worker
runs a session) or on the profiled actor alone (its runtime env, as phase
14 does), and prints one JSON line a run: the phase's seconds and its
split, the capture's `startup_s`, the first session's seconds and the
stream's, or the error that stopped it (phase 14's own checks, its 120 s
limit included).

It imports nothing of JAX and exits 1 without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LAUNCHES = 2000
TURNS = ("none", "prep", "prep", "none")


def _launch_us(x, batches: int = 5) -> float:
    """Host microseconds a small launch takes: the median over `batches`
    of LAUNCHES in-place adds, each batch synchronised."""
    import torch

    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            x.add_(1.0)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / LAUNCHES * 1e6)
    return statistics.median(per)


def child(kind: str) -> int:
    sys.path.insert(0, REPO)
    if kind == "prep":
        os.environ["RT_PROFILER_PREP"] = "1"
    import torch

    from ray_tpu_torch._private import telemetry

    x = torch.zeros(1024, device="cuda")
    _launch_us(x, 2)  # warm
    rec = {"kind": kind, "launch_us_before": _launch_us(x)}
    prep = None
    if kind == "prep":
        prep = telemetry.TorchProfilerPrep()
        gaps, per = [], []
        t0 = last = time.perf_counter()
        prep.poll()
        while not prep.ready.is_set():
            if time.perf_counter() - t0 > 120:
                raise SystemExit("the prep's session did not end in 120 s")
            for _ in range(20):
                x.add_(1.0)
            torch.cuda.synchronize()
            now = time.perf_counter()
            gaps.append(now - last)
            per.append((now - last) / 20 * 1e6)
            last = now
        rec.update(session_s=time.perf_counter() - t0,
                   first_session_s=prep.first_session_s,
                   main_thread_max_gap_s=max(gaps, default=None),
                   launch_us_during=statistics.median(per) if per else None,
                   batches_during=len(gaps))
        rec["launch_us_after_session"] = _launch_us(x)
    rec["capture_startup_s"] = [
        telemetry.torch_profile(2.0, prep)["startup_s"] for _ in range(2)]
    rec["launch_us_after_captures"] = _launch_us(x)
    print("probe " + json.dumps(rec), flush=True)
    return 0


def capture_child(variant: str, delay: float) -> int:
    """One process of `--captures`: see the module's docstring."""
    import concurrent.futures
    import threading

    import torch

    x = torch.zeros(1024, device="cuda")
    _launch_us(x, 2)  # CUDA initialised and warm
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            for _ in range(20):
                x.add_(1.0)
            torch.cuda.synchronize()

    def first_session():
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=ACTIVITIES):
            pass
        return time.perf_counter() - t0

    def capture(asked: float):
        import tempfile

        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            wait = time.perf_counter() - asked
            time.sleep(1.0)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return wait, sum(1 for e in events if e.get("cat") == "kernel")

    ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    launcher = threading.Thread(target=launch, daemon=True)
    launcher.start()
    one = concurrent.futures.ThreadPoolExecutor(1)
    other = one if variant == "same" else \
        concurrent.futures.ThreadPoolExecutor(1)
    lock = threading.Lock()  # the capture waits for the first session

    def locked(fn, *a):
        with lock:
            return fn(*a)

    first = one.submit(locked, first_session)
    time.sleep(delay)
    wait, kernels = other.submit(locked, capture, time.perf_counter()).result()
    stop.set()
    launcher.join()
    print("captures " + json.dumps(
        {"variant": variant, "delay_s": delay,
         "first_session_s": first.result(), "capture_wait_s": wait,
         "kernel_events": kernels}), flush=True)
    return 0


def captures() -> int:
    env = {k: v for k, v in os.environ.items() if k != "RT_PROFILER_PREP"}
    runs = [(v, d) for d in (1.0, 4.0, 20.0) for v in ("cross", "same")]
    for batch in [runs[i:i + 4] for i in range(0, len(runs), 4)] + \
            [[r] for r in runs]:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--capture-child",
             v, str(d)], env=env) for v, d in batch]
        for proc in procs:
            if proc.wait(timeout=300) != 0:
                return proc.returncode
    return 0


def ops() -> int:
    """`--ops`: see the module's docstring."""
    import traceback

    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import OpenAIServer

    kernels.build_all()
    server = OpenAIServer(LLMConfig(**chip_smoke.SERVE), max_batch=8,
                          decode_chunk=16, default_max_tokens=64,
                          device="cuda")
    try:
        _, lone = chip_smoke.phase_serve(server, kernels)
    finally:
        server.shutdown()
    del server
    torch.cuda.empty_cache()
    failed = 0
    for variant in ("cluster", "actor", "actor", "cluster"):
        if variant == "cluster":
            os.environ["RT_PROFILER_PREP"] = "1"
        else:
            os.environ.pop("RT_PROFILER_PREP", None)
        t0 = time.perf_counter()
        try:
            rec = chip_smoke.phase_ops(lone)
            res = {"variant": variant, "ok": True,
                   "phase_s": rec["phase_s"], "seconds": rec["seconds"],
                   "startup_s": rec.get("profile_startup_s"),
                   "first_session_s": rec.get("profile_first_session_s"),
                   "stream_s": rec["stream"]["s"]}
        except Exception as e:
            traceback.print_exc()
            failed += 1
            res = {"variant": variant, "ok": False, "error": repr(e)[:300],
                   "wall_s": time.perf_counter() - t0}
        print("ops " + json.dumps(res), flush=True)
    os.environ.pop("RT_PROFILER_PREP", None)
    return 0 if failed < 4 else 1


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    if len(sys.argv) == 4 and sys.argv[1] == "--capture-child":
        return capture_child(sys.argv[2], float(sys.argv[3]))
    import torch

    if not torch.cuda.is_available():
        print("chip_profiler_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if sys.argv[1:] == ["--captures"]:
        return captures()
    if sys.argv[1:] == ["--ops"]:
        return ops()
    env = {k: v for k, v in os.environ.items() if k != "RT_PROFILER_PREP"}
    for kind in TURNS:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", kind], env=env, timeout=300)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

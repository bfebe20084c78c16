"""Cluster telemetry: continuous node/worker resource sampling + on-demand
in-process profiling.

Parity target: the reference's reporter plane (dashboard/modules/reporter/
reporter_agent.py streams per-node CPU/mem/GPU samples into the metrics
head; its profiling endpoints serve on-demand py-spy captures of live
workers). Here the plane rides existing seams instead of new daemons:

- sampling: armed by RT_TELEMETRY_INTERVAL_S (unset => NO sampler thread
  anywhere and heartbeat frames stay byte-identical — the
  zero-cost-when-off pattern). The node agent samples node CPU/mem/disk and
  per-worker RSS/CPU% from /proc on its own loop; each worker samples
  device-side series (`torch.cuda.memory_stats()` bytes once CUDA is
  initialised, device-object-plane bytes from device_store) on a daemon
  thread and pushes them to its agent.
- transport: samples piggyback on the existing agent->controller heartbeats
  (`telemetry` key, batched) — no new connection or cadence, same as the
  span drain.
- profiling: `sample_profile()` is the worker-side CPU sampling profiler
  behind `ray-tpu profile --mode cpu` — sys._current_frames() walked at
  RT_PROFILE_HZ for the capture window, rendered as collapsed stacks plus
  Chrome-trace flame events (the generalization of the per-pid SIGUSR1
  one-shot stack dump into a timed sampler).

Everything here is stdlib + /proc reads; torch and device_store are
observed through sys.modules gates so a process that never imported them
never pays (or triggers) the import.

Counterpart: ray_tpu/_private/telemetry.py. Its jax compile listener has no
counterpart in eager torch, so the port reports no compile series; its
`jax_profile` window is `torch_profile` here (profile mode "torch").
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

from ray_tpu_torch._private.rtconfig import CONFIG


def interval_s() -> float:
    """Sampling cadence; <= 0 means the telemetry plane is OFF."""
    try:
        return float(CONFIG.telemetry_interval_s)
    except (TypeError, ValueError):
        return 0.0


_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


class CpuTracker:
    """Whole-node CPU utilization percent from /proc/stat deltas between
    successive percent() calls (first call returns 0.0 — no window yet)."""

    def __init__(self):
        self._last: Optional[tuple] = None  # (busy_jiffies, total_jiffies)

    @staticmethod
    def _read() -> Optional[tuple]:
        try:
            with open("/proc/stat") as f:
                line = f.readline()
        except OSError:
            return None
        parts = line.split()
        if not parts or parts[0] != "cpu":
            return None
        vals = [int(v) for v in parts[1:]]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
        total = sum(vals)
        return (total - idle, total)

    def percent(self) -> float:
        cur = self._read()
        if cur is None:
            return 0.0
        last, self._last = self._last, cur
        if last is None or cur[1] <= last[1]:
            return 0.0
        busy = cur[0] - last[0]
        total = cur[1] - last[1]
        return round(100.0 * max(0, busy) / max(1, total), 2)


class PidCpuTracker:
    """Per-pid CPU percent from /proc/<pid>/stat utime+stime deltas.
    Tracks many pids; entries for pids not seen in a sweep are pruned."""

    def __init__(self):
        self._last: dict[int, tuple] = {}  # pid -> (jiffies, monotonic)

    @staticmethod
    def _read_jiffies(pid: int) -> Optional[int]:
        try:
            with open(f"/proc/{pid}/stat") as f:
                data = f.read()
        except OSError:
            return None
        # comm may contain spaces/parens: fields start after the last ')'.
        try:
            rest = data[data.rindex(")") + 2:].split()
            return int(rest[11]) + int(rest[12])  # utime + stime
        except (ValueError, IndexError):
            return None

    def percent(self, pid: int) -> float:
        jif = self._read_jiffies(pid)
        now = time.monotonic()
        if jif is None:
            self._last.pop(pid, None)
            return 0.0
        last = self._last.get(pid)
        self._last[pid] = (jif, now)
        if last is None or now <= last[1]:
            return 0.0
        dt = now - last[1]
        return round(100.0 * max(0, jif - last[0]) / _CLK_TCK / dt, 2)

    def prune(self, live_pids) -> None:
        live = set(live_pids)
        for pid in [p for p in self._last if p not in live]:
            self._last.pop(pid, None)


def pid_rss_bytes(pid: int) -> Optional[int]:
    try:
        with open(f"/proc/{pid}/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None


def mem_percent() -> float:
    """Node memory utilization percent (MemTotal vs MemAvailable)."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        return 0.0
    return round(100.0 * (1.0 - avail / total), 2)


def disk_percent(path: str) -> float:
    try:
        st = os.statvfs(path)
    except OSError:
        return 0.0
    total = st.f_blocks * st.f_frsize
    free = st.f_bavail * st.f_frsize
    if total <= 0:
        return 0.0
    return round(100.0 * (1.0 - free / total), 2)


# ------------------------------------------------------- worker-side sampler
class WorkerSampler:
    """Daemon thread inside a worker process sampling device-side series and
    pushing them to the node agent (worker_telemetry). Started by
    worker_proc ONLY when RT_TELEMETRY_INTERVAL_S is set — with the plane
    off this class is never instantiated (no thread, pinned by test)."""

    THREAD_NAME = "rt-telemetry"

    def __init__(self, push: Callable[[dict], None], interval: float):
        self._push = push
        self._interval = max(0.05, interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=self.THREAD_NAME)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                series = self.sample()
            except Exception:
                continue  # a bad sample tick must never kill the thread
            if series:
                try:
                    self._push(series)
                except Exception:
                    pass  # agent away; next tick retries

    @staticmethod
    def sample() -> dict:
        """One device-side sample. Every source is sys.modules-gated: a
        worker that never touched torch's CUDA runtime or the device plane
        reports nothing for those series (and never triggers their
        import)."""
        out: dict = {}
        torch = sys.modules.get("torch")
        # Gate on CUDA being ALREADY initialised, not merely torch being
        # imported: a memory query on a cold runtime would create a CUDA
        # context from the sampler thread, costing device memory (and
        # seconds) in a worker that may never compute on the card.
        if torch is not None and torch.cuda.is_initialized():
            used = peak = 0
            for d in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(d)
                used += int(ms.get("allocated_bytes.all.current", 0))
                peak += int(ms.get("allocated_bytes.all.peak", 0))
            out["hbm_used"] = used
            out["hbm_peak"] = peak
        ds = sys.modules.get("ray_tpu_torch._private.device_store")
        if ds is not None:
            try:
                st = ds.table_stats()
                out["device_bytes"] = int(st.get("bytes") or 0)
            except Exception:
                pass
        eng = sys.modules.get("ray_tpu_torch.llm.engine")
        if eng is not None:
            # Live decode throughput (README "Serving hot loop"): tokens
            # delivered to stream consumers since the previous tick. Only
            # workers that actually host a continuous engine ever import
            # the module, so everyone else skips the series entirely.
            try:
                out["llm.tokens_per_s"] = round(
                    eng.tokens_per_s_snapshot(), 2)
            except Exception:
                pass
        xch = sys.modules.get("ray_tpu_torch.data._internal.exchange")
        if xch is not None:
            # Exchange pressure (README "Data plane"): blocks in flight,
            # bytes spilled through the storage plane, and submit-loop
            # backpressure stalls. The module only loads in processes that
            # drive or execute an exchange.
            try:
                st = xch.exchange_stats()
                out["data.blocks_inflight"] = st["blocks_inflight"]
                out["data.spilled_bytes"] = st["spilled_bytes"]
                out["data.bp_stalls"] = st["bp_stalls"]
            except Exception:
                pass
        pp = sys.modules.get("ray_tpu_torch.llm.pipeline")
        if pp is not None:
            # Pipeline-stage occupancy (README "Pipeline-parallel
            # serving"): busy fraction of this process's stage(s) since
            # the previous tick — the bubble is its complement. Only
            # processes hosting a PipelineStage import the module.
            try:
                occ = pp.occupancy_snapshot("telemetry")
                if occ:
                    out["llm.pp_occupancy"] = round(max(occ.values()), 3)
            except Exception:
                pass
        return out


# --------------------------------------------------- CPU sampling profiler
#: Raw stack snapshots kept per capture (~KBs each across a worker's
#: threads): bounds capture RSS at tens of MB worst case.
_MAX_PROFILE_SAMPLES = 20_000


def clamp_profile_seconds(seconds) -> float:
    """One capture-window clamp shared by every hop of the profile path
    (controller -> agent -> worker): 0.05s floor, 300s cap, 5s default.
    The hops' RPC timeouts come from `profile_timeout`, tuned against these
    constants — change them here, nowhere else."""
    try:
        seconds = float(seconds)
    except (TypeError, ValueError):
        seconds = 5.0  # unset/garbage -> default; explicit 0 clamps to floor
    return min(300.0, max(0.05, seconds))


#: Seconds a capture may wait before its window opens: a torch capture
#: waits for the profiler to go live (a worker's first CUPTI session took
#: 8.5-16 s on an H100; `TorchProfilerPrep` takes it off the capture path,
#: and a capture that arrives while it runs waits for it).
PROFILE_STARTUP_ALLOWANCE_S = 30.0
#: Each hop's margin beyond the window and the start-up: the worker's
#: export (agent -> worker), the agent's persist (controller -> agent), the
#: controller's reply (client -> controller).
_PROFILE_HOP_MARGIN_S = {"worker": 30.0, "node": 40.0, "client": 60.0}


def profile_timeout(seconds: float, hop: str) -> float:
    """The RPC timeout of one hop of the profile path ("worker": agent ->
    worker, "node": controller -> agent, "client": CLI -> controller) for
    a window of `seconds` (already clamped): the window, the start-up
    allowance and the hop's margin, each outer hop above the inner one."""
    return seconds + PROFILE_STARTUP_ALLOWANCE_S + _PROFILE_HOP_MARGIN_S[hop]


def sample_profile(seconds: float, hz: Optional[int] = None,
                   exclude_thread: Optional[int] = None) -> dict:
    """In-process CPU sampling profile over ALL of this process's threads:
    sys._current_frames() walked at `hz` for `seconds`, folded into
    collapsed stacks (root;...;leaf -> sample count, the flamegraph input)
    and reconstructed into Chrome-trace flame events (one lane per thread;
    consecutive samples sharing a frame prefix merge into one "X" event).
    `exclude_thread` drops the sampler's own lane. Runs on a caller-owned
    thread — the capture loop sleeps between samples."""
    if hz is None:
        try:
            hz = int(CONFIG.profile_hz)
        except (TypeError, ValueError):
            hz = 100
    hz = max(1, min(1000, int(hz)))
    seconds = max(0.05, float(seconds))
    period = 1.0 / hz
    me = threading.get_ident()
    names = {t.ident: t.name for t in threading.enumerate()}
    samples: list[tuple[float, dict]] = []  # (t_rel, tid -> stack tuple)
    t0 = time.monotonic()
    deadline = t0 + seconds
    while True:
        now = time.monotonic()
        if now >= deadline or len(samples) >= _MAX_PROFILE_SAMPLES:
            # The raw-snapshot buffer is bounded: profiling must never
            # OOM the live worker it is observing (an extreme
            # seconds x hz request ends early with what it has; the
            # returned `seconds` reflects the actual window).
            break
        frames = sys._current_frames()
        snap: dict[int, tuple] = {}
        for tid, frame in frames.items():
            if tid == me or tid == exclude_thread:
                continue
            stack = []
            f = frame
            depth = 0
            while f is not None and depth < 128:
                code = f.f_code
                stack.append(f"{code.co_name} "
                             f"({os.path.basename(code.co_filename)}:"
                             f"{f.f_lineno})")
                f = f.f_back
                depth += 1
            snap[tid] = tuple(reversed(stack))  # root -> leaf
        samples.append((now - t0, snap))
        time.sleep(max(0.0, period - (time.monotonic() - now)))
    duration = time.monotonic() - t0

    collapsed: dict[str, int] = {}
    for _, snap in samples:
        for stack in snap.values():
            key = ";".join(stack)
            collapsed[key] = collapsed.get(key, 0) + 1
    events = _flame_events(samples, names, period)
    return {
        "mode": "cpu",
        "pid": os.getpid(),
        "hz": hz,
        "seconds": round(duration, 3),
        "samples": len(samples),
        "threads": sorted({tid for _, s in samples for tid in s}),
        "collapsed": collapsed,
        "traceEvents": events,
    }


def _flame_events(samples: list, names: dict, period: float) -> list[dict]:
    """Merge per-thread sample stacks into Chrome-trace complete events: at
    each depth, a run of consecutive samples sharing the same frame (and
    the same ancestry) becomes one "X" event. Timestamps are relative
    microseconds; lanes (tid) are OS thread ids with name metadata."""
    by_tid: dict[int, list[tuple[float, tuple]]] = {}
    for t, snap in samples:
        for tid, stack in snap.items():
            by_tid.setdefault(tid, []).append((t, stack))
    events: list[dict] = []
    lane = 0
    for tid, rows in by_tid.items():
        lane += 1
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": lane,
                       "args": {"name": f"{names.get(tid) or tid}"}})
        open_ev: list[dict] = []  # stack of open events, one per depth
        prev: tuple = ()
        for i, (t, stack) in enumerate(rows):
            # Close events where the frame (or an ancestor) changed.
            common = 0
            while (common < len(prev) and common < len(stack)
                   and prev[common] == stack[common]):
                common += 1
            end_us = t * 1e6
            while len(open_ev) > common:
                ev = open_ev.pop()
                ev["dur"] = max(1.0, end_us - ev["ts"])
            for d in range(common, len(stack)):
                ev = {"ph": "X", "name": stack[d], "cat": "sample",
                      "pid": 1, "tid": lane, "ts": t * 1e6, "dur": 1.0}
                events.append(ev)
                open_ev.append(ev)
            prev = stack
        tail = (rows[-1][0] + period) * 1e6 if rows else 0.0
        while open_ev:
            ev = open_ev.pop()
            ev["dur"] = max(1.0, tail - ev["ts"])
    return events


def _torch_profiler_activities() -> list:
    """Host ops, and the CUDA kernels where this process has initialised
    CUDA (a capture never initialises it)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class TorchProfilerPrep:
    """Takes a process's first torch.profiler session off the capture path.

    The first session of a process that has initialised CUDA pays CUPTI's
    start-up (8.5-16 s for a serving worker on an H100, later sessions
    about 1 s). A worker holds one of these and calls `poll()` after each
    item it executes; where the `profiler_prep` flag is set, the first poll
    that finds CUDA initialised starts one empty session on a daemon thread
    (beside the worker's work, which it can stall for a moment), else the
    prep never starts. `torch_profile` takes `lock`, so a capture that
    arrives during that session waits for it, its reply's `startup_s`
    counts the wait, and `first_session_s` is the session's length."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ready = threading.Event()  # set once the session has ended
        self.first_session_s: Optional[float] = None
        self._started = False

    def poll(self) -> None:
        if self._started:
            return
        # No torch in this process, or another thread still importing it
        # (the module is in sys.modules before it has its names): CUDA is
        # not initialised yet.
        cuda = getattr(sys.modules.get("torch"), "cuda", None)
        is_initialized = getattr(cuda, "is_initialized", None)
        if is_initialized is None or not is_initialized():
            return
        self._started = True
        if not CONFIG.profiler_prep:
            return
        threading.Thread(target=self._prepare, daemon=True,
                         name="rt-profiler-prep").start()

    def _prepare(self) -> None:
        import torch

        try:
            with self.lock:
                t0 = time.perf_counter()
                with torch.profiler.profile(
                        activities=_torch_profiler_activities()):
                    pass
                self.first_session_s = time.perf_counter() - t0
        except Exception:
            pass  # a capture then pays the start-up itself, and reports it
        finally:
            self.ready.set()


def torch_profile(seconds: float,
                  prep: Optional[TorchProfilerPrep] = None) -> dict:
    """Capture a torch.profiler window (host ops of every thread, and the
    CUDA kernels' device timeline where this process has initialised
    CUDA) and return its Chrome trace as a zip archive blob. The window
    opens once the profiler is live: `startup_s` is the time from the call
    to then (a wait for `prep`'s session included), apart from the
    window's `seconds`. The caller surfaces failures as attributed
    errors."""
    import contextlib
    import io
    import tempfile
    import zipfile

    import torch

    # every thread's host ops: this runs on an executor thread, the
    # model's work and its `tracing.device_span`s on others
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    seconds = max(0.05, float(seconds))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rt-torchprof-") as d:
        with prep.lock if prep is not None else contextlib.nullcontext():
            with torch.profiler.profile(
                    activities=_torch_profiler_activities(),
                    experimental_config=every_thread) as prof:
                startup_s = time.perf_counter() - t0
                time.sleep(seconds)
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            z.write(path, "trace.json")
    rep = {"mode": "torch", "pid": os.getpid(),
           "seconds": round(seconds, 3), "startup_s": round(startup_s, 3),
           "files": 1, "archive": buf.getvalue()}
    if prep is not None and prep.first_session_s is not None:
        rep["first_session_s"] = round(prep.first_session_s, 3)
    return rep


def default_profile_dir(session_id: str) -> str:
    d = CONFIG.profile_dir
    if d:
        return d
    return os.path.join(CONFIG.session_dir, session_id, "profiles")

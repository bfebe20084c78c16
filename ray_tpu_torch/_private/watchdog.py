"""Stall detection: per-task progress beacons, a flight recorder, and the
warn -> dump -> kill escalation ladder (README "Stall detection & watchdogs").

The failure mode this closes is SILENT: a task spinning in user code, a
collective wedged on a sick peer, a worker alive with its socket open but
making no progress. None of the loud-failure machinery (connection-close
liveness, worker-death reports, lease failover) fires for these — the
reference runtime needs its health-check manager
(gcs_health_check_manager.cc) and per-attempt timeouts (task_manager.cc)
for exactly this reason.

Three pieces, all in-process and cheap enough to leave compiled in:

- **Progress beacons**: every executing task registers here (task_begin /
  task_end); user code can tick the beacon mid-task via
  `ray_tpu_torch.util.report_progress()`, and runtime-level progress points
  (collective ring steps, streamed generator items) tick it too. "Progress"
  is a monotonic timestamp per executing thread.

- **Flight recorder**: a bounded ring of recent runtime events (task
  begin/end, collective enter/exit, RPC frame send/recv, progress reports).
  Recording is a deque append behind one enabled-flag check; the ring is
  dumped into the `StallReport` on escalation so the operator sees what the
  process was doing in the seconds before it went quiet.

- **Monitor thread** (`Watchdog`): wakes every beacon interval, measures
  each executing task's silence (now - last progress), and emits a
  structured `StallReport` through its callback as the task crosses
  RT_STALL_WARN_S / RT_STALL_DUMP_S / RT_STALL_KILL_S — each stage at most
  once per (task_id, attempt). The worker process never kills itself: the
  kill-stage report reaches the node agent, which captures stacks through
  its existing per-pid dump path, persists the flight dump through the
  storage plane, and fells the worker so the attempt fails over through the
  ordinary retry machinery.

All stages default OFF (0 = disabled); with every threshold unset the
monitor thread never starts and nothing beacons — behavior is byte-identical
to a watchdog-free build.

Counterpart: ray_tpu/_private/watchdog.py (copied).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from ray_tpu_torch._private.rtconfig import CONFIG

# The whole plane is ARMED only when a Watchdog with at least one enabled
# stage starts in this process. Unarmed (the default — every RT_STALL_*
# unset), task_begin/task_end/record are one module-global check and
# return: the n:n actor hot path pays nothing for the stall machinery.
_armed = False

# ------------------------------------------------------------ flight recorder
# Ring of (wall_time, kind, detail). While armed it costs one module-global
# check + a deque append per event; RT_FLIGHT_RECORDER_EVENTS=0 disables
# the ring even when armed.
_ring: Optional[deque] = None
_ring_lock = threading.Lock()


def _ensure_ring() -> Optional[deque]:
    global _ring
    if _ring is None:
        n = CONFIG.flight_recorder_events
        if n <= 0:
            return None
        with _ring_lock:
            if _ring is None:
                _ring = deque(maxlen=int(n))
    return _ring


def record(kind: str, detail: str = "") -> None:
    """Append one event to the flight recorder (no-op when unarmed)."""
    ring = _ring
    if ring is None:
        if not _armed:
            return
        ring = _ensure_ring()
        if ring is None:
            return
    ring.append((time.time(), kind, detail))


def flight_events(limit: int = 64) -> list:
    """Most recent `limit` recorded events, oldest first. Readers race
    RPC-thread appends; list(deque) can raise RuntimeError mid-mutation,
    so snapshotting retries — an escalation report must never be lost to
    a ring race."""
    ring = _ring
    if ring is None:
        return []
    for _ in range(4):
        try:
            evs = list(ring)
            return evs[-limit:]
        except RuntimeError:
            continue
    return []


def is_armed() -> bool:
    return _armed


# -------------------------------------------------------------- progress state
# One entry per thread currently executing a task: thread ident ->
# {"task_id", "name", "attempt", "kind", "started", "last_progress"}.
# Multiple entries exist on threaded/async actors; the monitor scans all.
_executing: dict[int, dict] = {}
_exec_lock = threading.Lock()
_local = threading.local()


def task_begin(task_id: str, name: str, attempt: int, kind: str,
               trace_id: str | None = None) -> None:
    if not _armed:
        return
    now = time.monotonic()
    st = {"task_id": task_id, "name": name, "attempt": attempt, "kind": kind,
          "started": now, "last_progress": now, "trace_id": trace_id}
    ident = threading.get_ident()
    _local.state = st
    with _exec_lock:
        _executing[ident] = st
    record("task_begin", f"{name} {task_id[:12]} a{attempt}")


def task_end(ok: bool = True) -> None:
    if not _armed:
        return
    ident = threading.get_ident()
    _local.state = None
    with _exec_lock:
        st = _executing.pop(ident, None)
    if st is not None:
        record("task_end", f"{st['name']} {st['task_id'][:12]} "
                           f"{'ok' if ok else 'err'}")


def report_progress(message: str | None = None) -> None:
    """Tick the current task's progress beacon (public:
    `ray_tpu_torch.util.report_progress`). Call this from long-running user code
    so the stall watchdog knows the task is alive; a no-op outside a task
    (and when the watchdog plane is idle)."""
    st = getattr(_local, "state", None)
    if st is not None:
        st["last_progress"] = time.monotonic()
    if message:
        record("progress", message)


def progress_slice_s(default: float = 0.25) -> float:
    """Wait-slice length for loops that block on EXTERNAL progress
    (compiled-DAG channel reads, armed collective recvs): while the stall
    plane is armed, indefinite waits must be chopped into slices shorter
    than the beacon interval with a `report_progress()` tick per slice, so
    an idle wait is never mistaken for a stalled task. Unarmed, callers
    keep their own (longer) default — the tick is a no-op anyway."""
    if not _armed:
        return default
    try:
        return max(0.05, min(default,
                             float(CONFIG.stall_beacon_interval_s) / 2.0))
    except Exception:
        return default


def executing_snapshot() -> list[dict]:
    """Copies of every executing-task state (monitor + beacon source)."""
    with _exec_lock:
        return [dict(st) for st in _executing.values()]


# --------------------------------------------------------------- stall report
def stages() -> dict[str, float]:
    """Enabled escalation thresholds ({} = escalation fully disabled)."""
    out = {}
    for stage, flag in (("warn", CONFIG.stall_warn_s),
                        ("dump", CONFIG.stall_dump_s),
                        ("kill", CONFIG.stall_kill_s)):
        if flag and flag > 0:
            out[stage] = float(flag)
    return out


def enabled() -> bool:
    return bool(stages())


def default_flight_dir(session_id: str) -> str:
    return os.path.join(CONFIG.session_dir, session_id, "flight")


def build_report(st: dict, stage: str, *, worker_id: str, node_id: str,
                 pid: int, session_id: str, silence_s: float,
                 reason: str | None = None) -> dict:
    """One structured StallReport — the unit the agent forwards, the
    controller aggregates (`util.state.list_stalls`), and the storage plane
    persists under <flight_dir>/ on dump/kill escalation."""
    return {
        "scope": "task",
        "stage": stage,
        "task_id": st.get("task_id"),
        "name": st.get("name"),
        "attempt": st.get("attempt", 0),
        "kind": st.get("kind"),
        # Tracing linkage: a stalled TRACED task's report names its trace,
        # so `ray-tpu stalls` links straight to `ray-tpu timeline --trace`.
        "trace_id": st.get("trace_id"),
        "worker_id": worker_id,
        "node_id": node_id,
        "pid": pid,
        "silence_s": round(float(silence_s), 3),
        "running_s": round(time.monotonic() - st.get("started", 0.0), 3),
        "time": time.time(),
        "reason": reason or f"no progress for {silence_s:.1f}s",
        "events": flight_events(),
        # CONFIG resolves _system_config overrides first, then the
        # RT_STALL_FLIGHT_DIR env (train runs inject it per worker).
        "flight_dir": (CONFIG.stall_flight_dir
                       or default_flight_dir(session_id)),
    }


class Watchdog:
    """Per-worker monitor thread driving the escalation ladder.

    `on_report(report)` runs on the monitor thread for each stage crossing;
    `on_beacon(task_id_or_None, silence_s)` runs every tick so the node
    agent can detect a worker whose monitor thread itself got starved (user
    code holding the GIL in native code) — beacons stopping IS the signal
    the agent-side backstop escalates on."""

    def __init__(self, *, worker_id: str, node_id: str, session_id: str,
                 on_report: Callable[[dict], None],
                 on_beacon: Callable[[Optional[str], float], None] | None = None):
        self.worker_id = worker_id
        self.node_id = node_id
        self.session_id = session_id
        self.on_report = on_report
        self.on_beacon = on_beacon
        self._pid = os.getpid()
        # (task_id, attempt) -> set of stages already emitted.
        self._emitted: dict[tuple, set] = {}
        # (task_id, attempt) -> trace id minted by the always-sample
        # escalation for UNSAMPLED stalled tasks (tracing.escalation_root);
        # later stages of the same attempt reuse it.
        self._esc_traces: dict[tuple, str] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> bool:
        global _armed
        if not enabled():
            return False  # escalation disabled: no thread, no beacons
        _armed = True
        if _ensure_ring() is not None:
            # RPC frame events feed the ring only while the stall plane is
            # armed (the hook costs one global check per frame otherwise).
            from ray_tpu_torch._private import rpc as _rpc

            _rpc.set_flight_hook(record)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rt-watchdog")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        ladder = sorted(stages().items(), key=lambda kv: kv[1])
        interval = max(0.05, float(CONFIG.stall_beacon_interval_s))
        while not self._stop.wait(interval):
            try:
                self._tick(ladder)
            except Exception:
                pass  # the watchdog must never take the worker down

    def _tick(self, ladder: list) -> None:
        now = time.monotonic()
        states = executing_snapshot()
        live_keys = set()
        worst_silence = 0.0
        beacon_task = None
        for st in states:
            key = (st["task_id"], st["attempt"])
            live_keys.add(key)
            silence = now - st["last_progress"]
            if silence > worst_silence:
                worst_silence = silence
                beacon_task = st["task_id"]
            emitted = self._emitted.setdefault(key, set())
            for stage, threshold in ladder:
                if silence >= threshold and stage not in emitted:
                    # Mark emitted only AFTER a successful hand-off: a
                    # report lost to a reconnecting agent connection (or a
                    # transient build failure) retries next tick instead of
                    # being swallowed forever — a permanently-swallowed
                    # kill stage would recreate the very hang this plane
                    # exists to prevent.
                    delivered = False
                    try:
                        rep = build_report(
                            st, stage, worker_id=self.worker_id,
                            node_id=self.node_id, pid=self._pid,
                            session_id=self.session_id, silence_s=silence)
                        if rep.get("trace_id") is None:
                            # Always-sample escalation: an UNSAMPLED (or
                            # untraced-root) stalled task still gets a
                            # trace root so the report links to a
                            # timeline. No-op with tracing off.
                            rep["trace_id"] = self._stall_trace(key, st)
                        delivered = self.on_report(rep) is not False
                    except Exception:
                        delivered = False
                    if delivered:
                        emitted.add(stage)
                        record("stall_" + stage,
                               f"{st['name']} silent {silence:.1f}s")
        # Prune ladder bookkeeping of finished attempts.
        for key in [k for k in self._emitted if k not in live_keys]:
            self._emitted.pop(key, None)
        for key in [k for k in self._esc_traces if k not in live_keys]:
            self._esc_traces.pop(key, None)
        if self.on_beacon is not None:
            try:
                self.on_beacon(beacon_task, worst_silence)
            except Exception:
                pass

    def _stall_trace(self, key: tuple, st: dict):
        """Mint (once per attempt) an escalation trace root for a stalled
        task that carries no sampled trace context."""
        tid = self._esc_traces.get(key)
        if tid is None:
            from ray_tpu_torch._private import tracing

            tid = tracing.escalation_root(st)
            if tid is not None:
                self._esc_traces[key] = tid
        return tid

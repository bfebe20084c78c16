"""Cluster event plane: durable, causal lifecycle events.

Parity target: the reference's event framework (src/ray/util/event.h, the
dashboard's `list_cluster_events` state API, and the export-event sinks).
Tracing answers "where did this request's time go" and telemetry
answers "what is the cluster doing right now"; this plane
answers "what happened and why" AFTER the fact — a dead actor, a fenced
node, a stall kill — without grepping per-process logs.

One Event record per lifecycle transition the runtime already knows about:

    {"seq":  int,      # controller-minted, monotonic arrival order
     "ts":   float,    # emission wall time
     "sev":  str,      # debug | info | warning | error
     "kind": str,      # a key of the KINDS registry below
     "src":  str,      # emitting process label (worker id / pidN / node id)
     "node": str|None, # node the event is about (filled at ingest when the
                       # frame arrived on a node connection)
     "entity": [str],  # ids this event explains: actor/worker/task/lease/
                       # node/job/run ids — `list_events(entity=)` matches
                       # any of them by prefix
     "msg":  str,
     "attrs": {...},      # optional, kind-specific (e.g. {"cause": "crash"})
     "trace_id": str|None # optional trace linkage: `ray-tpu events` ->
                          # `ray-tpu timeline --trace` chains
    }

Life of an event:

- worker/driver side: `emit_event` appends to a bounded per-process ring;
  the ring drains to the controller piggybacked on the existing 1 Hz
  metrics-flush batches (`events=` key — the span-drain idiom, no
  new connection or cadence).
- node-agent side: the agent keeps its own bounded pending deque; batches
  ride heartbeat frames (and worker_died pushes, so an exit event's seq
  always precedes the restart/failover events its processing mints —
  causal chains stay ordered under arrival-order seq minting).
- controller side: events index into a bounded arrival ring plus a
  per-entity secondary index; settled events persist through the storage
  plane under `<session>/events/` as segmented JSONL with
  keep-last-K rotation, so history survives controller snapshot/restore
  (the snapshot carries the seq counter; restore also scans the persisted
  segments so a restored head can never re-mint colliding seqs).

Surfaces: `util.state.list_events(entity=, kind=, severity=, since=)`,
`ray-tpu events [--follow] [--entity ID]`, the dashboard's `/api/events` +
recent-events panel, and error enrichment — ActorDiedError /
ObjectLostError messages name the event seq range that explains them.

Cost discipline (pinned by the bench `events_overhead` lane): emission is
always-on but BOUNDED — every ring is a deque with a cap, and nothing on
the per-task hot path emits (lifecycle transitions are orders of magnitude
rarer than tasks). RT_EVENTS_BUFFER=0 disables the plane entirely: no
ring, no `events=` keys on any frame, `enabled()` is one cached bool.

Counterpart: ray_tpu/_private/events.py (copied).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch._private.rtconfig import CONFIG

SEVERITIES = ("debug", "info", "warning", "error")

#: The kind registry: every `emit_event(kind=...)` literal in ray_tpu_torch/ MUST
#: be declared here (enforced by the rtcheck `event-kinds` pass — a typo'd
#: kind would be unqueryable forever). kind -> (default severity, what the
#: event marks).
KINDS: dict[str, tuple[str, str]] = {
    # --- node lifecycle (controller-emitted) -------------------------------
    "node_register": ("info", "a node agent registered a fresh life"),
    "node_reconciled": ("info", "a SUSPECT/known node re-registered and was "
                                "reconciled in place"),
    "node_suspect": ("warning", "a node's control connection closed; frozen "
                                "for the suspicion grace window"),
    "node_dead": ("error", "a node was declared dead"),
    "incarnation_fenced": ("warning", "a message/lease from a previous node "
                                      "incarnation was rejected"),
    # --- worker lifecycle (agent-emitted) ----------------------------------
    "worker_start": ("debug", "a worker process was spawned"),
    "worker_exit": ("info", "a worker process exited (attrs.cause carries "
                            "the normalized exit cause)"),
    # --- actors (controller-emitted) ---------------------------------------
    "actor_create": ("info", "an actor creation was accepted"),
    "actor_ready": ("info", "an actor instance came up (created, restarted, "
                            "or re-bound after a blip)"),
    "actor_restart": ("warning", "an actor instance died and a restart was "
                                 "queued"),
    "actor_death": ("error", "an actor is permanently dead"),
    # --- direct-dispatch lease plane ---------------------------------------
    "lease_failover": ("warning", "a leased worker died; its lease was "
                                  "invalidated and in-flight specs fail "
                                  "over"),
    "lease_dedup_replay": ("info", "an agent replayed a recorded outcome "
                                   "for a failover re-dispatch (exactly-"
                                   "once dedup)"),
    # --- device object plane -----------------------------------------------
    "device_objects_lost": ("warning", "a producer died taking its pinned "
                                       "device objects with it"),
    # --- storage / checkpoints (worker-emitted) ----------------------------
    "checkpoint_commit": ("info", "a checkpoint manifest committed"),
    "checkpoint_gc": ("debug", "checkpoint retention/GC deleted a "
                               "checkpoint directory"),
    # --- train / serve (driver- and replica-worker-emitted) ----------------
    "train_restart": ("warning", "a train worker group failed and restarts "
                                 "from the latest committed checkpoint"),
    "serve_deploy": ("info", "a serve deployment was created or updated"),
    "serve_scale": ("info", "a serve deployment's replica target changed"),
    "serve_replica_death": ("warning", "a serve replica failed its health "
                                       "check or failed to start"),
    "serve_overload": ("warning", "a serve deployment's router queue "
                                  "saturated and began shedding (first "
                                  "shed after a quiet period)"),
    "serve_shed": ("warning", "serve admission control shed requests "
                              "(throttled aggregate; attrs carry the "
                              "per-reason counts since the last event)"),
    "serve_proxy_join": ("info", "a serve HTTP proxy came up and joined "
                                 "the controller's proxy registry"),
    "serve_stream_sever": ("warning", "a push-stream link was severed (or "
                                      "lost a frame) mid-stream; the SSE "
                                      "client got an attributed error"),
    # --- compiled dataflow graphs (driver-emitted) -------------------------
    "dag_compiled": ("info", "a DAG was compiled into persistent stage "
                             "loops wired by pre-negotiated shm channels"),
    "dag_stage_death": ("error", "a compiled-DAG stage died mid-run "
                                 "(attrs.stage names it); every in-flight "
                                 "invocation failed with DagStageError"),
    "dag_teardown": ("info", "a compiled DAG tore down; all stage loops "
                             "stopped and every channel was unlinked"),
    # --- data plane exchanges (driver-emitted) -----------------------------
    "data_exchange": ("info", "an all-to-all exchange (shuffle/sort/"
                              "repartition) completed; attrs carry map/"
                              "partition counts and spilled bytes"),
    "data_spill": ("warning", "an exchange spilled shards through the "
                              "storage plane under memory pressure"),
    # --- jobs (controller-emitted) -----------------------------------------
    "job_start": ("info", "a job driver subprocess was launched"),
    "job_stop": ("info", "a job reached a terminal state"),
    # --- watchdog escalation (controller-emitted on StallReport ingest) ----
    "stall": ("warning", "a stall-escalation stage was crossed (attrs.stage "
                         "= warn|dump|kill; carries the stalled task's "
                         "trace_id)"),
    # --- the plane's own bookkeeping ---------------------------------------
    "events_dropped": ("warning", "the persistence buffer overflowed while "
                                  "the backend was unreachable; oldest "
                                  "events were shed"),
}


# --------------------------------------------------------------------------
# Worker-exit cause enum — ONE vocabulary shared by worker_died reports,
# events (worker_exit attrs.cause), lease_invalid causes, and StallReports,
# so `ray-tpu events` queries by cause actually match across planes
# (previously: "oom"/"stall"/None/free-text reasons depending on the path).
# --------------------------------------------------------------------------
CAUSE_CRASH = "crash"          # unexpected process exit (incl. signals)
CAUSE_OOM = "oom"              # felled by the node memory monitor
CAUSE_STALL = "stall"          # felled by the stall-watchdog kill stage
CAUSE_IDLE_REAP = "idle_reap"  # idle pool worker collected by the reaper
CAUSE_KILLED = "killed"        # explicit kill (ray_tpu_torch.kill, force-cancel)
CAUSE_SHUTDOWN = "shutdown"    # clean exit (code 0 / session teardown)

EXIT_CAUSES = (CAUSE_CRASH, CAUSE_OOM, CAUSE_STALL, CAUSE_IDLE_REAP,
               CAUSE_KILLED, CAUSE_SHUTDOWN)


def normalize_exit_cause(cause: Optional[str], reason: str = "") -> str:
    """Collapse the historical per-path cause spellings (raw signal ints,
    "killed" vs "stall", None-with-a-reason-string) into the enum above."""
    if cause in EXIT_CAUSES:
        return cause
    r = (str(cause or "") + " " + (reason or "")).lower()
    if "oom" in r or "memory monitor" in r:
        return CAUSE_OOM
    if "stall" in r:
        return CAUSE_STALL
    if "idle" in r and "reap" in r:
        return CAUSE_IDLE_REAP
    if "kill" in r or "cancel" in r:
        return CAUSE_KILLED
    if "exit code 0" in r or "shutdown" in r or "disconnect" in r:
        return CAUSE_SHUTDOWN
    return CAUSE_CRASH


# --------------------------------------------------------------------------
# Per-process emission ring (drained by the metrics flusher — the tracing
# span-ring idiom from _private/tracing.py).
# --------------------------------------------------------------------------
_ON: Optional[bool] = None  # cached enabled flag (None = unresolved)
_ring: Optional[deque] = None
_ring_lock = threading.Lock()
_pid = os.getpid()
_proc_label: Optional[str] = None


def enabled() -> bool:
    global _ON
    if _ON is None:
        try:
            _ON = int(CONFIG.events_buffer) > 0
        except Exception:
            _ON = True
    return _ON


def refresh() -> None:
    """Re-resolve the enabled flag after Worker.connect loads the cluster
    config snapshot (so `_system_config={"events_buffer": 0}` reaches every
    process), mirroring tracing.refresh()."""
    global _ON
    try:
        _ON = int(CONFIG.events_buffer) > 0
    except Exception:
        _ON = True
    if not _ON and _ring:
        _ring.clear()


def _get_ring() -> deque:
    global _ring
    ring = _ring
    if ring is None:
        with _ring_lock:
            if _ring is None:
                try:
                    cap = int(CONFIG.events_buffer)
                except Exception:
                    cap = 2048
                _ring = deque(maxlen=max(64, cap))
            ring = _ring
    return ring


def proc_label() -> str:
    """This process's display label (worker-id prefix, or pidN before a
    Worker exists — pidN is never cached so it can upgrade later). Shared
    by the event AND span records (tracing delegates here — one caching
    subtlety, one implementation)."""
    global _proc_label
    lbl = _proc_label
    if lbl is None:
        try:
            from ray_tpu_torch._private.worker import global_worker

            w = global_worker()
            lbl = w.worker_id[:12] if w is not None else f"pid{_pid}"
        except Exception:
            lbl = f"pid{_pid}"
        if not lbl.startswith("pid"):
            _proc_label = lbl  # worker id is stable; pidN may upgrade later
    return lbl


def drain_ring(ring: Optional[deque]) -> list:
    """Pop everything off a piggyback ring (popleft-until-empty: concurrent
    producer appends during the drain land in the NEXT batch instead of
    racing a len() snapshot)."""
    if not ring:
        return []
    out = []
    try:
        while True:
            out.append(ring.popleft())
    except IndexError:
        pass
    return out


def build_event(kind: str, message: str = "", *,
                severity: Optional[str] = None,
                entity=(), node_id: Optional[str] = None,
                trace_id: Optional[str] = None,
                attrs: Optional[dict] = None,
                src: Optional[str] = None) -> dict:
    """One Event record (seq-less; the controller mints seq at ingest)."""
    ev: dict = {
        "ts": time.time(),
        "sev": severity or (KINDS.get(kind, ("info", ""))[0]),
        "kind": kind,
        "src": src or proc_label(),
        "node": node_id,
        "entity": [str(e) for e in entity if e],
        "msg": message,
    }
    if attrs:
        ev["attrs"] = attrs
    if trace_id:
        ev["trace_id"] = trace_id
    return ev


def emit_event(kind: str, message: str = "", *,
               severity: Optional[str] = None,
               entity=(), node_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               attrs: Optional[dict] = None) -> None:
    """Append one lifecycle event to this process's ring; it reaches the
    controller on the next metrics-flush tick. No-op when the plane is
    disabled (RT_EVENTS_BUFFER=0)."""
    if not enabled():
        return
    _get_ring().append(build_event(
        kind, message, severity=severity, entity=entity, node_id=node_id,
        trace_id=trace_id, attrs=attrs))
    try:
        from ray_tpu_torch.util import metrics

        metrics.ensure_flusher()
    except Exception:
        pass


def drain() -> list:
    """Pop all buffered events (called from the metrics flusher)."""
    return drain_ring(_ring)


def requeue_front(ring: Optional[deque], items: Optional[list],
                  lock: Optional[threading.Lock] = None) -> None:
    """ONE shed-oldest requeue discipline for every bounded piggyback ring
    (process event/span rings, the agent's heartbeat deques): put drained-
    but-unsent items back at the FRONT via per-item appendleft while the
    ring has headroom, stopping when full — the remaining (OLDEST) items
    shed, never entries appended since the drain. A naive extendleft
    would evict the freshest off the right end on overflow; a
    list/clear/extend rebuild would silently drop a producer's concurrent
    append (producers never hold a lock — appends are single GIL-atomic
    deque ops on hot paths). `lock` only excludes concurrent REQUEUES of
    the same ring."""
    if ring is None or not items:
        return
    if lock is not None:
        with lock:
            _requeue_items(ring, items)
    else:
        _requeue_items(ring, items)


def _requeue_items(ring: deque, items: list) -> None:
    for it in reversed(items):
        if ring.maxlen is not None and len(ring) >= ring.maxlen:
            return  # full of fresher entries: the older remainder sheds
        ring.appendleft(it)


def requeue(events: list) -> None:
    """Put drained-but-unsent events back at the FRONT of the ring (the
    metrics flusher raced a shutdown) so the forced final flush still
    delivers them."""
    requeue_front(_ring, events, _ring_lock)


def default_events_dir(session_id: str) -> str:
    return os.path.join(CONFIG.session_dir, session_id, "events")

"""Per-process client runtime: ownership, objects, task/actor submission.

Parity target: the reference core worker (src/ray/core_worker/core_worker.h:166)
+ its Python face (python/ray/_private/worker.py): TaskManager (task_manager.h:175,
retries + lineage resubmit cc:313), ReferenceCounter (reference_count.h:72),
in-process memory store (memory_store.h:45), plasma provider
(plasma_store_provider.h:93), direct actor transport
(transport/actor_task_submitter.h:78 — ordered per-caller queues over a direct
worker connection).

Every process (driver and executing workers alike) hosts one `Worker`:
an IO event-loop thread, an RPC server (serves `fetch_object` and, on actor
workers, `actor_call`), a shared-memory LocalStore view, and one connection to
the controller.

Counterpart: ray_tpu/_private/worker.py (copied; GPU tasks, not TPU tasks,
take the controller-dispatch path).
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import struct
import threading
import time
import traceback
from collections import deque
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Optional

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import device_store, rpc
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.ids import ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.lease import LeaseManager, _record_dispatch
from ray_tpu_torch._private.object_store import LocalStore
from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch._private.serialization import (
    SerializedObject,
    deserialize,
    dumps_oob,
    loads_oob,
    serialize,
)
from ray_tpu_torch._private.task_spec import (
    ACTOR_CREATE,
    ACTOR_TASK,
    DEVICE_REF,
    NORMAL,
    STREAMING,
    SchedulingStrategy,
    TaskSpec,
)

logger = logging.getLogger(__name__)

_MODE_DRIVER = "driver"
_MODE_WORKER = "worker"


class ObjectRef:
    """A future for an object in the cluster (reference: ObjectRef in
    python/ray/includes/object_ref.pxi; ownership semantics from
    reference_count.h:72 — only the owner process refcounts; deserialized
    copies are BORROWED and pin the object at the controller via the
    borrower protocol (borrow_add/borrow_drop) until dropped)."""

    __slots__ = ("_oid", "_owned", "_worker", "_borrow", "__weakref__")

    def __init__(self, oid: str, owned: bool = False, worker: "Worker" = None,
                 borrow: bool = False):
        self._oid = oid
        self._owned = owned
        self._worker = worker
        self._borrow = False
        if owned and worker is not None:
            worker._incref(oid)
        elif borrow and worker is not None:
            # Registers with the controller (deduped per process); False for
            # oids this process owns anyway.
            self._borrow = worker._borrow_incref(oid)

    def hex(self) -> str:
        return self._oid

    def binary(self) -> bytes:
        return bytes.fromhex(self._oid)

    def task_id(self) -> str:
        return ObjectID.from_hex(self._oid).task_id().hex()

    def __hash__(self):
        return hash(self._oid)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._oid == self._oid

    def __repr__(self):
        return f"ObjectRef({self._oid[:16]})"

    def __del__(self):
        if self._worker is not None:
            try:
                if self._owned:
                    self._worker._decref(self._oid)
                elif self._borrow:
                    self._worker._borrow_decref(self._oid)
            except Exception:
                pass

    def __reduce__(self):
        # Plain-pickle fallback (e.g. a ref captured in a closure): the
        # deserialized copy is a borrowed ref bound to that process's worker.
        return (_borrowed_ref, (self._oid,))

    def future(self):
        """concurrent.futures.Future view of this ref."""
        import concurrent.futures

        f: concurrent.futures.Future = concurrent.futures.Future()

        def _bg():
            try:
                f.set_result(self._worker.get([self])[0] if self._worker else None)
            except Exception as e:
                f.set_exception(e)

        threading.Thread(target=_bg, daemon=True).start()
        return f


def _borrowed_ref(oid: str) -> ObjectRef:
    return ObjectRef(oid, owned=False, worker=global_worker(), borrow=True)


_watchers_lock = threading.Lock()


class _Resolution:
    """Per-object resolution slot.

    The blocking Event is created LAZILY by the first waiter that actually
    has to block: in pipelined/async workloads most results arrive before
    get() looks at them, and a threading.Event costs a Condition + Lock
    allocation — measurable at tens of thousands of calls/s on one core."""

    __slots__ = ("done", "event", "inline", "holders", "error", "watchers")

    def __init__(self):
        self.done = False
        self.event = None  # lazily-created by a blocking waiter
        self.inline = None
        self.holders: list = []
        self.error = None
        self.watchers = None  # lazily-created list of resolve callbacks

    def add_watcher(self, cb) -> bool:
        """Run cb at resolve time, exactly once. Returns False if already
        resolved — the CALLER must then run cb itself. The lock serializes
        against resolve()'s swap so a callback can never be lost or run
        twice."""
        with _watchers_lock:
            if self.done:
                return False
            if self.watchers is None:
                self.watchers = []
            self.watchers.append(cb)
            return True

    def wait(self, timeout=None) -> bool:
        if self.done:
            return True
        with _watchers_lock:
            if self.done:
                return True
            ev = self.event
            if ev is None:
                ev = self.event = threading.Event()
        return ev.wait(timeout)

    def remove_watcher(self, cb):
        """Deregister a watcher added by add_watcher (no-op if it already
        ran or was cleared by resolve)."""
        with _watchers_lock:
            if self.watchers is not None:
                try:
                    self.watchers.remove(cb)
                except ValueError:
                    pass

    def resolve(self, inline, holders, error):
        # Values are published BEFORE done flips; the GIL orders these for
        # readers that check `done` without the lock.
        self.inline = inline
        self.holders = holders or []
        self.error = error
        with _watchers_lock:
            self.done = True
            ev = self.event
            ws, self.watchers = self.watchers, None
        if ev is not None:
            ev.set()
        for cb in ws or ():
            try:
                cb()
            except Exception:
                pass

    def reset(self):
        """Re-arm in place (reconstruction): getters already blocked on
        `event` keep waiting on THIS object, so it must not be replaced."""
        with _watchers_lock:
            self.inline = None
            self.holders = []
            self.error = None
            self.done = False
            if self.event is not None:
                self.event.clear()


class _GenState:
    """Owner-side state of one streaming-generator task (reference
    TaskManager's ObjectRefStream, task_manager.h:175 area). Items arrive as
    `gen_items` pushes on the same ordered connection as the final reply;
    the completion sentinel's resolution (watching it drives finish())
    carries the authoritative item count so a completion that overtakes
    trailing items — or a retry re-reporting earlier indices — cannot
    truncate or duplicate the stream."""

    __slots__ = ("task_id", "cond", "queue", "produced", "consumed", "done",
                 "total", "error", "conn", "ack_stride")

    def __init__(self, task_id: str, ack_stride: int):
        self.task_id = task_id
        self.cond = threading.Condition()
        self.queue: deque = deque()  # oids ready to consume
        self.produced = 0  # next expected item index
        self.consumed = 0
        self.done = False
        self.total: int | None = None  # authoritative count, once known
        self.error = None
        self.conn = None  # connection items arrived on (for acks)
        self.ack_stride = ack_stride

    def finish(self, total: int | None, error):
        with self.cond:
            if self.done:
                return
            if error is not None:
                self.error = error
                # Drain whatever made it here, then raise.
                self.total = self.produced
            else:
                self.total = self.produced if total is None else total
            self.done = True
            self.cond.notify_all()

    def conn_lost(self, error):
        """The connection items were riding died. Items and the completion
        reply ride two independently-flushed batch pushers, so a completion
        (total=N) can be processed while trailing items are still buffered
        executor-side; if the conn then dies those items are gone forever —
        truncate the stream with an error instead of waiting on gs.cond
        for items that can never arrive."""
        with self.cond:
            if self.done and self.error is None and self.total is not None \
                    and self.produced < self.total:
                self.error = error
                self.total = self.produced
                self.cond.notify_all()


class ObjectRefGenerator:
    """Iterator of ObjectRefs from a `num_returns="streaming"` task
    (reference python/ray/_raylet.pyx ObjectRefGenerator). next() blocks
    until the executor reports the next yielded item; the stream ends with
    StopIteration, or raises the task's error after the last good item."""

    def __init__(self, worker: "Worker", task_id: str, completion_ref: "ObjectRef"):
        self._worker = worker
        self._task_id = task_id
        # Holding the completion ref keeps its resolution (and the error
        # path) alive for the generator's lifetime.
        self._completion_ref = completion_ref

    @property
    def task_id(self) -> str:
        return self._task_id

    def completed(self) -> "ObjectRef":
        """Ref that resolves to the item count when the stream finishes
        (or raises the stream's error)."""
        return self._completion_ref

    def __iter__(self):
        return self

    def __next__(self):
        return self._next(None)

    def next(self, timeout: float | None = None):
        """Like __next__ but raises GetTimeoutError after `timeout`."""
        return self._next(timeout)

    def _next(self, timeout: float | None):
        w = self._worker
        gs = w._generators.get(self._task_id)
        if gs is None:
            raise StopIteration
        deadline = None if timeout is None else time.monotonic() + timeout
        need_ack = False
        with gs.cond:
            while True:
                if gs.queue:
                    oid = gs.queue.popleft()
                    gs.consumed += 1
                    need_ack = (gs.ack_stride > 0 and gs.conn is not None
                                and gs.consumed % gs.ack_stride == 0)
                    break
                if gs.done and not gs.queue and (
                        gs.total is None or gs.consumed >= gs.total):
                    w._generators.pop(self._task_id, None)
                    if gs.error is not None:
                        raise w._decode_error(gs.error)
                    raise StopIteration
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise exc.GetTimeoutError(
                        f"generator {self._task_id[:12]} timed out")
                gs.cond.wait(rem if rem is not None else 1.0)
        if need_ack:
            try:
                gs.conn.push_threadsafe(
                    "gen_ack", task_id=self._task_id, consumed=gs.consumed)
            except Exception:
                pass
        return ObjectRef(oid, owned=True, worker=w)

    def cancel(self, force: bool = False):
        return self._worker.cancel_task(self._task_id, force)

    def __del__(self):
        try:
            self._worker._gen_destroy(self._task_id)
        except Exception:
            pass

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator cannot be pickled; consume it in the owner "
            "process and pass the yielded ObjectRefs instead.")


_global_worker: Optional["Worker"] = None
_global_lock = threading.Lock()


def global_worker() -> Optional["Worker"]:
    return _global_worker


def set_global_worker(w: Optional["Worker"]):
    global _global_worker
    with _global_lock:
        _global_worker = w


class Worker:
    def __init__(self, mode: str, session_id: str, controller_addr: tuple, node_id: str = "",
                 agent_addr: tuple | None = None, worker_id: str | None = None):
        self.mode = mode
        self.session_id = session_id
        self.controller_addr = controller_addr
        self.agent_addr = agent_addr
        self.node_id = node_id
        self.worker_id = worker_id or WorkerID.from_random().hex()
        self.io = rpc.EventLoopThread(name=f"rt-io-{self.worker_id[:6]}")
        self.server = rpc.RpcServer(self._on_request, self._on_push,
                                    on_close=self._on_server_conn_close)
        self.store = LocalStore(session_id, CONFIG.object_store_memory_bytes,
                                CONFIG.object_spill_dir, CONFIG.shm_dir)
        self.controller: Optional[rpc.Connection] = None
        self.server_addr: tuple = ("", 0)
        # Owned-object bookkeeping (reference ReferenceCounter):
        self._refcounts: dict[str, int] = {}
        self._refcounts_lock = threading.Lock()
        self._free_buf: list[str] = []
        self._free_escaped_buf: list[str] = []
        self._free_scheduled = False
        # Borrowed-ref pins held by this process: oid -> local borrow count.
        # The controller learns only the 0<->1 transitions.
        self._borrows: dict[str, int] = {}
        self._borrows_lock = threading.Lock()
        # Pull admission control (reference pull_manager.h:49).
        self._pull_cv = threading.Condition()
        self._pull_inflight = 0
        # Pubsub fan-in (util/pubsub.Subscriber callbacks).
        self.pubsub_listeners: list = []
        # Direct worker-to-worker collective messages (util/collective ring
        # transport) — set by the collective module when a group inits.
        self.collective_msg_cb = None
        self._escaped: set[str] = set()  # owned oids advertised on escape
        # Oids whose resolution came FROM the controller (queued-path
        # object_ready / object_lost): the controller holds directory state
        # for these, so their free must reach it (see _free fast path).
        self._ctrl_resolved: set[str] = set()
        self._resolutions: dict[str, _Resolution] = {}
        self._inline_cache: dict[str, list] = {}  # oid -> blob parts (small objs)
        # oid -> (expiry, detail): GetTimeoutError enrichment cache so a
        # tight polling loop pays the task_status probe once per window.
        self._status_cache: dict[str, tuple] = {}
        self._lineage: dict[str, TaskSpec] = {}  # return oid -> producing spec
        # Device-ref ARG pins: first-return oid -> dref arg oids whose
        # submit-time hold is dropped when that return ref is freed (the
        # args must outlive the result ref — lineage reconstruction re-runs
        # the spec and re-resolves them — but no longer: holding device
        # memory for the session per distinct array argument would leak).
        self._arg_pins: dict[str, tuple] = {}
        self._registered_fns: set[str] = set()
        self._fn_cache: dict[str, Any] = {}
        import weakref

        # fn -> fid, weakly keyed so dynamically created functions (and any
        # closure state they capture) stay collectible.
        self._fn_id_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # Direct actor transport: one ordered, pipelined, frame-coalescing
        # pipe per callee actor (reference ActorTaskSubmitter +
        # sequential_actor_submit_queue.h).
        self._actor_pipes: dict[str, "_ActorPipe"] = {}
        self._actor_info: dict[str, dict] = {}
        self._submit_lock = threading.Lock()
        self._submit_buf: list = []
        self._submit_flushing = False
        # Actor pipes with queued calls awaiting a pump: a same-tick burst
        # across N pipes costs ONE cross-thread loop wakeup, not N (the
        # self-pipe write behind run_coroutine_threadsafe is >100us on
        # some containers — it was ~18% of the n:n driver budget).
        self._pump_pipes: list = []
        self._pipe_pump_scheduled = False
        # Streaming generators owned by this process: task_id -> _GenState.
        self._generators: dict[str, _GenState] = {}
        # Hooks used by worker_proc: consumer acks for generator
        # backpressure, and consumer-side stream abandonment.
        self.gen_ack_handler = None  # def (task_id, consumed)
        self.gen_close_handler = None  # def (task_id)
        # Fires after a successful controller reconnect (worker_proc
        # rebinds its batched pushers to the new connection here).
        self.ctrl_reconnected_handler = None  # def ()
        # Hook used by worker_proc to execute actor calls in-order:
        self.actor_push_handler = None  # def (conn, spec)
        self.actor_batch_handler = None  # def (conn, list[spec]) — one frame
        # Hooks used by worker_proc for the direct (leased) task path:
        self.task_push_handler = None  # def (conn, spec) — enqueue for exec
        self.task_batch_handler = None  # def (conn, list[spec]) — one frame
        self.task_cancel_handler = None  # def (task_id)
        # Fires when an inbound connection to this worker's server closes
        # (worker_proc prunes per-connection reply pushers here).
        self.server_close_handler = None  # def (conn)
        self.lease_mgr = LeaseManager(self)
        self._shutdown = False
        self._reconnecting = False  # single-flight controller reconnect

    # ------------------------------------------------------------ lifecycle
    def connect(self):
        import os as _os

        # Bind on the node's externally-visible host (RT_HOST, set by the
        # node agent from its own --host) so direct worker-to-worker
        # connections — actor calls, leased task pushes, collective rings —
        # work across hosts; loopback only for single-machine defaults.
        bind_host = _os.environ.get("RT_HOST") or "127.0.0.1"

        async def _go():
            await self.server.start(bind_host, 0)
            self.server_addr = (bind_host, self.server.port)
            self.controller = await rpc.connect(
                *self.controller_addr,
                on_push=self._on_ctrl_push,
                on_close=self._on_ctrl_close,
                label="ctrl",
            )
            rep = await self.controller.call(
                "register", kind="client", worker_id=self.worker_id,
                mode=self.mode, address=self.server_addr
            )
            CONFIG.load_snapshot(rep["config"])

        self.io.run(_go(), timeout=CONFIG.connect_timeout_s)
        # Tracing plane: re-resolve RT_TRACING now the cluster snapshot is
        # in (and arm/disarm the rpc frame hook accordingly). The event
        # plane re-resolves the same way (RT_EVENTS_BUFFER=0 via
        # _system_config must reach every process).
        _tracing.refresh()
        from ray_tpu_torch._private import events as _events

        _events.refresh()

    def disconnect(self):
        self._shutdown = True
        # Final metrics/span flush BEFORE tearing anything down: without it
        # a short-lived driver loses up to one flush interval of trailing
        # counters and spans (the flusher refuses to push once _shutdown is
        # set — flush_on_shutdown forces the last batch out and fences it
        # with an acked ping so the controller has processed it).
        import sys as _sys

        _m = _sys.modules.get("ray_tpu_torch.util.metrics")
        if _m is not None:
            try:
                _m.flush_on_shutdown()
            except Exception:
                pass
        try:
            self.lease_mgr.shutdown()
        except Exception:
            pass

        async def _bye():
            await self.server.stop()
            if self.controller is not None:
                await self.controller.close()
            for pipe in self._actor_pipes.values():
                if pipe.conn is not None:
                    await pipe.conn.close()

        try:
            self.io.run(_bye(), timeout=5)
        except Exception:
            pass
        self.io.stop()
        try:
            device_store.on_worker_shutdown()
        except Exception:
            pass
        self.store.shutdown()
        if global_worker() is self:
            set_global_worker(None)

    def _on_server_conn_close(self, conn):
        h = self.server_close_handler
        if h is not None:
            h(conn)

    def _on_ctrl_close(self, conn):
        if self._shutdown:
            return
        # Controller restart FT (reference RayletNotifyGCSRestart): retry
        # the same address and re-register instead of dying — running work
        # (leased pipelines, actor pipes) rides direct connections and
        # keeps flowing throughout the outage.
        asyncio.ensure_future(self._a_ctrl_reconnect())

    async def _a_ctrl_reconnect(self):
        # Single-flight: a failed attempt's abandoned connection fires
        # on_close too, which would otherwise spawn N concurrent loops.
        if self._reconnecting:
            return
        self._reconnecting = True
        try:
            await self._a_ctrl_reconnect_inner()
        finally:
            self._reconnecting = False

    async def _a_ctrl_reconnect_inner(self):
        deadline = time.monotonic() + CONFIG.controller_reconnect_timeout_s
        logger.warning("worker %s: controller connection lost; retrying",
                       self.worker_id[:8])
        while not self._shutdown and time.monotonic() < deadline:
            conn = None
            try:
                conn = await rpc.connect(
                    *self.controller_addr,
                    on_push=self._on_ctrl_push,
                    on_close=self._on_ctrl_close,
                    timeout=5,
                    label="ctrl",
                )
                await conn.call(
                    "register", kind="client", worker_id=self.worker_id,
                    mode=self.mode, address=self.server_addr, _timeout=10)
                self.controller = conn
                # A restarted controller lost the histogram-boundary decls
                # this process registered (they ride ONE record per
                # session): forget the declared set so the next observe of
                # each histogram re-declares to the fresh controller.
                import sys as _sys

                _m = _sys.modules.get("ray_tpu_torch.util.metrics")
                if _m is not None:
                    try:
                        _m._hist_declared.clear()
                    except Exception:
                        pass
                h = self.ctrl_reconnected_handler
                if h is not None:
                    try:
                        h()
                    except Exception:
                        pass
                # Re-assert held leases so the restarted controller can
                # rebuild its resource accounting.
                self.lease_mgr.reassert()
                logger.info("worker %s: re-registered with restarted "
                            "controller", self.worker_id[:8])
                return
            except Exception:
                if conn is not None and not conn.closed:
                    try:
                        await conn.close()  # abandoned half-registration
                    except Exception:
                        pass
                await asyncio.sleep(0.5)
        if self._shutdown:
            return
        if self.mode == _MODE_WORKER:
            import os

            os._exit(1)  # cluster is really gone; workers die with it
        logger.error("driver: controller gone for %.0fs; subsequent "
                     "cluster calls will fail",
                     CONFIG.controller_reconnect_timeout_s)

    # --------------------------------------------------------- RPC handlers
    async def _on_request(self, conn, method, a):
        if method == "fetch_object":
            mv = self.store.get(a["oid"])
            if mv is None:
                parts = self._inline_cache.get(a["oid"])
                if parts is None:
                    return {"found": False}
                mv = memoryview(parts[0]) if len(parts) == 1 else \
                    memoryview(b"".join(bytes(p) for p in parts))
            off = a.get("offset")
            if off is None:
                return {"found": True, "data": mv, "size": len(mv)}
            # Chunked read (reference object transfer is chunked,
            # object_manager.h Push/Pull): a zero-copy slice of the shm view
            # rides the wire; the fetcher reassembles into its own segment.
            return {"found": True, "size": len(mv),
                    "data": mv[off : off + a["length"]]}
        if method == "export_device_object":
            # Device object plane tier-1/2 serving side: materialize the
            # pinned array's bytes into the local shm store (one host copy,
            # off the IO loop — a 64MB export must not stall frame
            # processing) so the consumer can attach or stream-fetch.
            found = await asyncio.to_thread(
                device_store.export_to_store, a["oid"], self.store)
            return {"found": bool(found)}
        if method == "health":
            return {"ok": True}
        if method == "whoami":
            # Peer-identity handshake: (host, port) is ambiguous across
            # worker generations (a new worker can reuse a dead worker's
            # ephemeral port), so direct-connection holders verify the
            # worker id before trusting the link.
            return {"worker_id": self.worker_id}
        raise rpc.RpcError(f"worker: unknown method {method}")

    async def _on_push(self, conn, method, a):
        # Direct (leased) task path: owners stream specs straight to this
        # worker's server (reference PushNormalTask, core_worker.proto:462).
        if method == "exec_tasks":
            specs = a.get("specs")
            if specs is None:  # compact form (TaskSpec.task_call_tuple)
                owner_id, owner_addr, resources = a["common"]
                owner_addr = tuple(owner_addr) if owner_addr else None
                specs = [
                    TaskSpec.for_normal_call(c, owner_id, owner_addr,
                                             resources)
                    for c in a["calls"]]
            if self.task_batch_handler is not None:
                # Whole frame as ONE exec-queue item (same shape as the
                # actor_calls path): per-spec queue put/get + condition
                # notify was a measurable slice of a leased worker's core
                # budget at direct-dispatch rates.
                self.task_batch_handler(conn, specs)
            elif self.task_push_handler is not None:
                for spec in specs:
                    self.task_push_handler(conn, spec)
        elif method == "actor_calls":
            if self.actor_batch_handler is not None:
                owner_id, owner_addr, actor_id = a["common"]
                owner_addr = tuple(owner_addr) if owner_addr else None
                self.actor_batch_handler(conn, [
                    TaskSpec.for_actor_call(
                        c[0], c[1], c[2], c[3], c[4], c[5],
                        owner_id, owner_addr, actor_id, attempt=c[6],
                        trace=(c[7] if len(c) > 7 else None))
                    for c in a["calls"]])
        elif method == "actor_tasks":  # full-spec form (compat)
            if self.actor_push_handler is not None:
                for spec in a["specs"]:
                    self.actor_push_handler(conn, spec)
        elif method == "cancel":
            if self.task_cancel_handler is not None:
                self.task_cancel_handler(a["task_id"])
        elif method == "gen_ack":
            h = self.gen_ack_handler
            if h is not None:
                h(a["task_id"], a["consumed"])
        elif method == "gen_close":
            h = self.gen_close_handler
            if h is not None:
                h(a["task_id"])
        elif method == "col_msg":
            cb = self.collective_msg_cb
            if cb is not None:
                cb(a)

    async def _on_ctrl_push(self, conn, method, a):
        if method == "pubsub":
            for cb in list(self.pubsub_listeners):
                try:
                    cb(a["channel"], a["payload"])
                except Exception:
                    pass
        elif method == "device_free":
            # Targeted unpin from the controller: the last reference to
            # device objects THIS process produced died (README "Device
            # objects" ownership). Export segments go with the pin.
            device_store.free_local(a["oids"], self.store)
        elif method == "lease_invalid":
            self.lease_mgr.on_lease_invalid(a["lease_id"], cause=a.get("cause"))
        elif method == "need_resources":
            self.lease_mgr.on_need_resources()
        elif method == "objects_ready":
            # Batched completion notifications: one frame resolves a whole
            # burst of owned oids.
            for item in a["items"]:
                self._apply_object_ready(item)
        elif method == "object_ready":  # single-oid form (compat)
            self._apply_object_ready(a)
        elif method == "worker_log":
            # Streamed worker stdout/stderr (reference log_monitor ->
            # driver printer, "(pid=...) ..." prefixes).
            import sys as _sys

            prefix = f"({a.get('pid')}, {a.get('node_id', '')[:8]})"
            for line in a.get("lines", []):
                print(f"{prefix} {line}", file=_sys.stderr)
        elif method == "object_lost":
            # All copies died with a node. Reconstruct from lineage if we can
            # (reference object_recovery_manager.cc:26), else fail waiters.
            oid = a["oid"]
            self._ctrl_resolved.add(oid)
            if not self._maybe_reconstruct_async(oid):
                msg = a.get("message") or f"object {oid[:16]} lost (node died)"
                h, bufs = dumps_oob({"type": "ObjectLostError",
                                     "message": msg})
                res = self._resolutions.setdefault(oid, _Resolution())
                res.resolve(None, [], [h, *bufs])

    def _apply_object_ready(self, a: dict):
        self._ctrl_resolved.add(a["oid"])
        res = self._resolutions.setdefault(a["oid"], _Resolution())
        res.resolve(a.get("inline"),
                    [tuple(h) for h in a.get("holders", [])], a.get("error"))

    # ----------------------------------------------------------- refcounts
    def _incref(self, oid: str):
        with self._refcounts_lock:
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1

    def _decref(self, oid: str):
        if self._shutdown:
            return
        free = False
        with self._refcounts_lock:
            n = self._refcounts.get(oid, 0) - 1
            if n <= 0:
                self._refcounts.pop(oid, None)
                free = True
            else:
                self._refcounts[oid] = n
        if free:
            self._free([oid])

    def _borrow_incref(self, oid: str) -> bool:
        """Register this process as a borrower of an oid it does not own.
        Returns True iff a borrow pin was actually taken (the matching
        __del__ must then drop it)."""
        if oid in self._resolutions or self._shutdown:
            return False  # our own object round-tripping back — not a borrow
        # The push happens UNDER the lock: add/drop frames must reach the
        # (ordered) controller connection in the same order as the local
        # 0<->1 transitions, or a drop can cancel a newer add.
        with self._borrows_lock:
            c = self._borrows.get(oid, 0)
            self._borrows[oid] = c + 1
            if c == 0:
                try:
                    self.controller.push_threadsafe(
                        "borrow_add", oid=oid, worker_id=self.worker_id)
                except Exception:
                    pass
        return True

    def _borrow_decref(self, oid: str):
        if self._shutdown:
            return
        with self._borrows_lock:
            c = self._borrows.get(oid, 0) - 1
            if c <= 0:
                self._borrows.pop(oid, None)
                try:
                    self.controller.push_threadsafe(
                        "borrow_drop", oid=oid, worker_id=self.worker_id)
                except Exception:
                    pass
            else:
                self._borrows[oid] = c

    def _free(self, oids: list[str]):
        remote: list[str] = []
        escaped_oids: list[str] = []
        released_args: list[str] = []
        for oid in oids:
            pins = self._arg_pins.pop(oid, None)
            if pins:
                # Result ref died: its task's device-arg pins die with it
                # (decref'd after the loop — a drop to zero re-enters
                # _free for the arg oid).
                released_args.extend(pins)
            self._inline_cache.pop(oid, None)
            escaped = oid in self._escaped
            ctrl = oid in self._ctrl_resolved
            if ctrl:
                self._ctrl_resolved.discard(oid)
            if escaped:
                self._escaped.discard(oid)
                res = self._resolutions.get(oid)
                if res is None or res.done or not res.add_watcher(
                        lambda o=oid: self._resolutions.pop(o, None)):
                    # Resolved (possibly between the check and add_watcher —
                    # registration failing means resolve already ran): the
                    # escape advertise has fired, pop now.
                    # Unresolved: the add_watcher above keeps the resolution
                    # until the producing task finishes, so the escape
                    # advertise can still reach the controller; watchers run
                    # in registration order, advertise before this pop.
                    self._resolutions.pop(oid, None)
                self._lineage.pop(oid, None)
                escaped_oids.append(oid)
                remote.append(oid)
                continue
            res = self._resolutions.get(oid)
            self._lineage.pop(oid, None)
            if (res is not None and not res.done and res.add_watcher(
                    lambda o=oid: self._resolutions.pop(o, None))):
                # Freed BEFORE the producing task completed (fire-and-forget
                # result ref dropped immediately): the reply must still
                # resolve THIS resolution object — completion watchers
                # (device-arg unpins, escape advertises) hang off it — so
                # keep it in the map until resolve pops it.
                res = None
            else:
                self._resolutions.pop(oid, None)
            # Purely-local object: resolved from a direct (lease/actor-pipe)
            # reply inline, never escaped this process, controller never
            # heard of it — its free is a no-op everywhere else, so don't
            # spend a controller frame + tombstone on it. This is the common
            # case for every small task/actor return consumed by its owner.
            if (not ctrl and res is not None and res.done
                    and not res.holders):
                continue
            # Device-plane pin produced by THIS process (driver put / dref
            # arg): drop it now rather than waiting for the controller's
            # device_free round trip. Escaped device oids skipped above
            # keep their pin while borrowers may still fetch (the grace
            # sweep's targeted device_free lands here via _on_ctrl_push).
            # has_pins() keeps the common host-path free at zero extra cost.
            if device_store.has_pins():
                device_store.free_local([oid])
            self.store.delete(oid)
            remote.append(oid)
        for o in released_args:
            self._decref(o)
        if not remote:
            return
        oids = remote
        # Batch the controller notification: refs die one at a time (GC),
        # but a burst of dying refs (the common teardown of a get() over
        # many results) must not cost one controller frame each.
        with self._refcounts_lock:
            self._free_buf.extend(oids)
            self._free_escaped_buf.extend(escaped_oids)
            need = not self._free_scheduled
            self._free_scheduled = True
        if need:
            try:
                self.io.spawn(self._a_flush_free())
            except Exception:
                # Un-wedge: the next free must be able to reschedule the
                # flush or the controller never hears about any of them.
                with self._refcounts_lock:
                    self._free_scheduled = False

    async def _a_flush_free(self):
        await asyncio.sleep(0.002)  # coalesce the burst
        with self._refcounts_lock:
            oids, self._free_buf = self._free_buf, []
            escaped, self._free_escaped_buf = self._free_escaped_buf, []
            self._free_scheduled = False
        if oids and not self._shutdown:
            try:
                await self.controller.push("free_objects", oids=oids,
                                           escaped=escaped)
            except Exception:
                pass

    # ----------------------------------------------------------------- put
    def put(self, value) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed.")
        if device_store.eligible(value):
            oid, _ = self._put_device(value)
            return ObjectRef(oid, owned=True, worker=self)
        oid = ObjectID.from_put().hex()
        sobj = serialize(value, ref_class=ObjectRef)
        if sobj.contained_refs:  # refs escape into the putted payload
            self._advertise_escaping(
                [r.hex() if isinstance(r, ObjectRef) else r
                 for r in sobj.contained_refs])
        self._store_blob(oid, sobj, register=True)
        return ObjectRef(oid, owned=True, worker=self)

    def _store_blob(self, oid: str, sobj: SerializedObject, register: bool) -> None:
        """Registration is a one-way push: the owner resolves locally, and a
        borrower's wait_object on the controller blocks until the push lands.
        Pushes and later calls share one ordered connection, so a task
        submitted after a put can never be scheduled before the controller
        knows the object (removes one round trip per put — the reference
        plasma Put is similarly fire-and-forget to the owner's local store)."""
        size = sobj.total_bytes()
        if size <= CONFIG.max_inline_object_bytes:
            parts = [sobj.to_bytes()]
            self._inline_cache[oid] = parts
            if register:
                self.controller.push_threadsafe(
                    "register_put", oid=oid, size=size, inline=parts,
                    holder=self.server_addr, owner=self.worker_id)
        else:
            # Serialize-into-shm: the pickle-5 out-of-band buffer views go
            # straight into the destination mmap (no intermediate parts
            # walk; threaded copy per buffer).
            self.store.put_serialized(oid, sobj)
            holder = self.agent_addr or self.server_addr
            if register:
                self.controller.push_threadsafe(
                    "register_put", oid=oid, size=size, inline=None,
                    holder=holder, owner=self.worker_id)
        res = self._resolutions.setdefault(oid, _Resolution())
        res.resolve(None, [self.server_addr], None)

    def _put_device(self, value) -> tuple[str, bytes]:
        """Device-plane put: pin the live array in this process's
        DeviceObjectTable and register only the placeholder with the
        controller (same fire-and-forget ordering argument as _store_blob).
        Returns (oid, placeholder_blob)."""
        oid = ObjectID.from_put().hex()
        blob, nbytes = device_store.pin_put(oid, value, self)
        self.controller.push_threadsafe(
            "register_put", oid=oid, size=nbytes, inline=[blob],
            holder=self.server_addr, owner=self.worker_id,
            **device_store.advert_fields(self.worker_id, self.node_id))
        res = self._resolutions.setdefault(oid, _Resolution())
        res.resolve([blob], [self.server_addr], None)
        return oid, blob

    # ----------------------------------------------------------------- get
    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(r, deadline) for r in refs]

    def _remaining(self, deadline) -> float | None:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise exc.GetTimeoutError("get() timed out")
        return rem

    def _get_one(self, ref: ObjectRef, deadline):
        oid = ref.hex()
        # 1. owned refs: resolved -> straight to materialize (the hot path
        # for harvesting a batch of results); pending -> wait. The local
        # cache/shm probes are skipped either way: an owned object's bytes
        # cannot be locally visible before its resolution lands, and the
        # miss costs a stat per get() racing its producer.
        res = self._resolutions.get(oid)
        if res is not None:
            if not res.done:
                try:
                    rem = self._remaining(deadline)
                except exc.GetTimeoutError:
                    raise self._get_timeout_error(oid) from None
                if not res.wait(timeout=rem):
                    raise self._get_timeout_error(oid)
            return self._materialize(oid, res.inline, res.holders, res.error, deadline)
        # 2. local caches (in-process inline / same-host shm, zero-copy)
        val, found = self._try_local(oid)
        if found:
            return val
        # 3. borrowed refs: ask the controller directly
        rep = self.io.run(self.controller.call(
            "wait_object", oid=oid, timeout=self._remaining(deadline)))
        if rep["status"] == "timeout":
            raise self._get_timeout_error(oid)
        if rep["status"] == "lost":
            raise exc.ObjectLostError(f"object {oid[:16]} lost")
        return self._materialize(oid, rep.get("inline"), [tuple(h) for h in rep.get("holders", [])],
                                 rep.get("error"), deadline)

    def _get_timeout_error(self, oid: str) -> "exc.GetTimeoutError":
        """Enriched get() timeout: name the producing task's CURRENT status
        — queued or running, where, and how long since its last progress
        beacon (the first question a stalled-get user asks). Direct-path
        tasks resolve from this owner's lease tables; everything else (and
        the beacon age) from the controller. Diagnostics only: every lookup
        is best-effort and bounded so enrichment can never hang the error."""
        # Polling loops (`get(ref, timeout=0.05)` in a while) expire this
        # path at high rate: cache the enriched detail per oid for a couple
        # of seconds so the controller round trip below is paid once per
        # window, not once per poll.
        now = time.monotonic()
        cached = self._status_cache.get(oid)
        if cached is not None and cached[0] > now:
            return exc.GetTimeoutError(
                f"get() timed out on {oid[:16]}{cached[1]}")
        detail = ""
        try:
            tid = ObjectID.from_hex(oid).task_id().hex()
            st = self.lease_mgr.task_status(tid) or {}
            if not st.get("found"):
                # Actor calls ride direct pipes: the inflight table is the
                # only place that knows the call is still outstanding.
                for aid, pipe in list(self._actor_pipes.items()):
                    ent = pipe.inflight.get(tid)
                    state = "running"
                    if ent is None:
                        # Not yet pushed (actor still resolving/creating):
                        # the call is parked in the pipe's queue.
                        ent = next((e for e in list(pipe.queue)
                                    if e[0].task_id == tid), None)
                        state = "queued (actor not ready)"
                    if ent is not None:
                        info = self._actor_info.get(aid) or {}
                        st = {"found": True, "state": state,
                              "via": "actor", "name": ent[0].name,
                              "attempt": ent[0].attempt,
                              "node_id": None,
                              "worker_id": info.get("worker_id"),
                              "beacon_age_s": None}
                        break
            ctrl = {}
            try:
                ctrl = self.io.run(self.controller.call(
                    "task_status", task_id=tid, _timeout=1), timeout=2)
            except Exception:
                pass
            if not st.get("found") and ctrl.get("found"):
                st = ctrl
            elif st.get("found") and st.get("beacon_age_s") is None:
                st["beacon_age_s"] = ctrl.get("beacon_age_s")
            if st.get("found"):
                name = st.get("name") or tid[:12]
                where = ""
                if st.get("node_id"):
                    where = f" on node {str(st['node_id'])[:8]}"
                    if st.get("worker_id"):
                        where += f" (worker {str(st['worker_id'])[:8]})"
                via = {"direct": " via direct dispatch",
                       "actor": " as an actor call"}.get(st.get("via"), "")
                beacon = st.get("beacon_age_s")
                if beacon is not None:
                    prog = f"; {beacon:.1f}s since its last progress beacon"
                elif st.get("state") in ("running", "queued"):
                    prog = ("; no progress beacon (stall watchdog idle — "
                            "set RT_STALL_WARN_S to enable)")
                else:
                    prog = ""
                detail = (f": producing task {name!r} (attempt "
                          f"{st.get('attempt')}) is {st.get('state')}"
                          f"{where}{via}{prog}")
            else:
                detail = (f": producing task {tid[:12]} is unknown to the "
                          f"cluster (finished, never submitted, or a put())")
        except Exception:
            detail = ""
        if len(self._status_cache) > 64:
            self._status_cache = {k: v for k, v in self._status_cache.items()
                                  if v[0] > now}
        self._status_cache[oid] = (now + 2.0, detail)
        return exc.GetTimeoutError(f"get() timed out on {oid[:16]}{detail}")

    def _try_local(self, oid: str):
        parts = self._inline_cache.get(oid)
        if parts is not None:
            return self._deserialize_blob(memoryview(parts[0]) if len(parts) == 1 else memoryview(b"".join(bytes(p) for p in parts))), True
        mv = self.store.get(oid)
        if mv is not None:
            return self._deserialize_blob(mv), True
        return None, False

    def _materialize(self, oid: str, inline, holders, error, deadline):
        if error is not None:
            raise self._decode_error(error)
        if inline is not None:
            blob = inline[0] if len(inline) == 1 else b"".join(bytes(p) for p in inline)
            if oid not in self._resolutions:
                # Cache for repeat gets of BORROWED refs only: owned refs
                # re-materialize from their resolution (step 1 of _get_one
                # never consults the cache), so the write was pure churn.
                self._inline_cache[oid] = [blob]
            if deadline is not None:
                # Device-ref placeholders do network work INSIDE the
                # deserialize — bound it by the caller's get() deadline.
                device_store.set_resolve_deadline(deadline)
                try:
                    return self._deserialize_blob(memoryview(blob))
                finally:
                    device_store.set_resolve_deadline(None)
            return self._deserialize_blob(memoryview(blob))
        val, found = self._try_local(oid)
        if found:
            return val
        # Remote fetch. Holders are shuffled so a hot object's readers fan
        # out across every node that already fetched a copy instead of all
        # hammering the producer — with add_location below this forms the
        # broadcast spread (reference push_manager's chunked broadcast).
        last_err = None
        holders = list(holders)
        if len(holders) > 1:
            import random

            random.shuffle(holders)
        for holder in holders:
            if tuple(holder) == tuple(self.server_addr):
                continue
            try:
                ok = self._fetch_from(tuple(holder), oid, deadline)
                if ok:
                    self.io.spawn(self.controller.push(
                        "add_location", oid=oid,
                        holder=self.agent_addr or self.server_addr))
                    mv = self.store.get(oid)
                    if mv is not None:
                        return self._deserialize_blob(mv)
            except Exception as e:  # holder gone; try next
                last_err = e
        # all holders failed -> try lineage reconstruction
        if self._maybe_reconstruct(oid):
            return self._get_one(ObjectRef(oid), deadline)
        raise exc.ObjectLostError(
            f"object {oid[:16]} unavailable (holders {holders}): {last_err}")

    def prefetch_object(self, oid: str, timeout: float = 120.0) -> None:
        """Localize an object's BYTES into this process's reach (inline
        cache or local shm) without deserializing — the warm-up half of
        _get_one for executor-side arg pre-localization (reference
        dependency_manager.h). Best-effort: failures are left for the real
        decode to surface."""
        if oid in self._inline_cache or self.store.contains(oid):
            return
        deadline = time.monotonic() + timeout
        res = self._resolutions.get(oid)
        if res is not None:
            if not res.wait(timeout):
                return
            holders, error, inline = res.holders, res.error, res.inline
        else:
            rep = self.io.run(self.controller.call(
                "wait_object", oid=oid, timeout=timeout))
            if rep["status"] != "ready":
                return
            holders = [tuple(h) for h in rep.get("holders", [])]
            error, inline = rep.get("error"), rep.get("inline")
        if error is not None or inline is not None or not holders:
            return  # inline/error payloads need no localization
        import random

        holders = list(holders)
        random.shuffle(holders)
        for holder in holders:
            if tuple(holder) == tuple(self.server_addr):
                return
            try:
                if self._fetch_from(tuple(holder), oid, deadline):
                    return
            except Exception:
                continue

    def _acquire_pull(self, nbytes: int):
        """Admission control (reference pull_manager.h:49): bound the bytes
        in flight across concurrent fetches. A single fetch is always
        admitted even when larger than the budget (no starvation)."""
        cap = CONFIG.pull_max_inflight_bytes
        with self._pull_cv:
            while self._pull_inflight > 0 and self._pull_inflight + nbytes > cap:
                self._pull_cv.wait(timeout=1.0)
            self._pull_inflight += nbytes

    def _release_pull(self, nbytes: int):
        with self._pull_cv:
            self._pull_inflight -= nbytes
            self._pull_cv.notify_all()

    def _fetch_from(self, holder: tuple, oid: str, deadline) -> bool:
        """Fetch an object into the local store in bounded chunks, with the
        NEXT chunk's request already in flight while the current chunk is
        copied into the stream segment — socket recv overlaps the memcpy
        (double buffering through LocalStore.begin_stream). Returns True
        once a local copy exists (including 'someone else fetched it
        first')."""
        chunk = CONFIG.object_chunk_bytes
        held = 2 * chunk  # double buffering holds up to two chunks in flight
        self._acquire_pull(held)
        try:
            rem = self._remaining(deadline)
            return self.io.run(
                self._a_fetch_from(holder, oid, chunk, rem),
                timeout=None if rem is None else rem + 5)
        except (asyncio.TimeoutError, _FuturesTimeout):
            raise exc.GetTimeoutError(f"fetch of {oid[:16]} timed out")
        finally:
            self._release_pull(held)

    async def _a_fetch_from(self, holder: tuple, oid: str, chunk: int,
                            timeout: float | None) -> bool:
        if timeout is not None:
            return await asyncio.wait_for(
                self._a_fetch_pipeline(holder, oid, chunk), timeout)
        return await self._a_fetch_pipeline(holder, oid, chunk)

    async def _a_fetch_pipeline(self, holder: tuple, oid: str,
                                chunk: int) -> bool:
        conn = await rpc.connect(*holder, timeout=5)
        stream = None
        nxt = None
        try:
            rep = await conn.call("fetch_object", oid=oid, offset=0,
                                  length=chunk)
            if not rep.get("found"):
                return False
            size = rep["size"]
            data = rep["data"]
            if size <= len(data):
                self.store.put(oid, [data])
                return True
            stream = self.store.begin_stream(oid, size)
            if stream is None:
                return True  # raced: a local copy already exists
            off = len(data)
            woff = 0
            while True:
                # Pipeline: request chunk k+1 BEFORE copying chunk k, and
                # do the copy in a worker thread so the event loop keeps
                # receiving the next chunk during the memcpy.
                nxt = (await conn.call_start("fetch_object", oid=oid,
                                             offset=off, length=chunk)
                       if off < size else None)
                await asyncio.to_thread(stream.write, woff, data)
                del data
                if nxt is None:
                    break
                rep = await nxt
                nxt = None
                if not rep.get("found"):
                    return False  # holder dropped it mid-stream
                data = rep["data"]
                woff = off
                off += len(data)
                del rep
            sealed = stream.seal()
            stream = None
            # seal() returning False means a concurrent fetch won the race
            # (a local copy exists) or the rename failed; either way the
            # store lookup below decides, so only claim success when the
            # object is actually there.
            return sealed or self.store.contains(oid)
        finally:
            if nxt is not None:
                # Cancellation/copy failure left the one-ahead request
                # un-awaited: consume its eventual error (call_start's
                # contract) so the loop never logs an unretrieved exception.
                nxt.add_done_callback(
                    lambda f: f.cancelled() or f.exception())
            if stream is not None:
                stream.abort()
            asyncio.ensure_future(conn.close())

    def _maybe_reconstruct(self, oid: str) -> bool:
        """Lineage reconstruction: resubmit the producing task (reference
        object_recovery_manager.cc:26 RecoverObject)."""
        if not CONFIG.lineage_reconstruction_enabled:
            return False
        spec = self._lineage.get(oid)
        if spec is None:
            return False
        logger.warning("reconstructing %s via task %s", oid[:12], spec.name)
        self._reset_resolution(oid)
        spec.attempt += 1
        self.io.run(self.controller.call("submit_task", spec=spec))
        return True

    def _reset_resolution(self, oid: str):
        res = self._resolutions.get(oid)
        if res is None:
            self._resolutions[oid] = _Resolution()
        else:
            res.reset()

    def _maybe_reconstruct_async(self, oid: str) -> bool:
        """Same as _maybe_reconstruct but safe to call ON the IO loop."""
        if not CONFIG.lineage_reconstruction_enabled:
            return False
        spec = self._lineage.get(oid)
        if spec is None:
            return False
        logger.warning("reconstructing %s via task %s (async)", oid[:12], spec.name)
        self._reset_resolution(oid)
        spec.attempt += 1
        asyncio.ensure_future(self.controller.call("submit_task", spec=spec))
        return True

    _NO_REFS_NO_BUFS = b"\x00" * 8  # [nrefs=0][nbufs=0] wire prefix

    def _deserialize_blob(self, mv):
        # Fast path for the dominant result shape (scalar/None, no embedded
        # refs, no oob buffers): one loads() straight off the header slice —
        # skips the SerializedObject parse + ref re-hydration machinery
        # (~2us/call at n:n harvest rates).
        if bytes(mv[:8]) == self._NO_REFS_NO_BUFS:
            (hlen,) = struct.unpack_from("<Q", mv, 8)
            return pickle.loads(mv[16:16 + hlen])
        return self._deser_with_refs(SerializedObject.from_buffer(mv))

    def _deser_with_refs(self, sobj: SerializedObject):
        # contained_refs are ObjectRef instances (fresh from serialize()) or
        # oid hex strings (parsed from a flattened blob) — re-hydrate either.
        refs = [
            r if isinstance(r, ObjectRef)
            else ObjectRef(r, owned=False, worker=self, borrow=True)
            for r in sobj.contained_refs
        ]
        return deserialize(sobj, resolve_ref=lambda idx: refs[idx])

    def _decode_error(self, error_parts) -> Exception:
        blob = loads_oob(bytes(error_parts[0]), [memoryview(p) for p in error_parts[1:]])
        etype = blob.get("type")
        if etype == "TaskError":
            cause = None
            if blob.get("cause") is not None:
                try:
                    cause = loads_oob(bytes(blob["cause"]), [])
                except Exception:
                    cause = None
            err = exc.TaskError(blob.get("function_name", "?"), blob.get("traceback", ""), cause)
            if cause is not None and isinstance(cause, Exception):
                err.__cause__ = cause
            return err
        if etype == "WorkerCrashedError":
            return exc.WorkerCrashedError(blob.get("message", ""))
        if etype == "OutOfMemoryError":
            return exc.OutOfMemoryError(blob.get("message", ""))
        if etype == "ActorDiedError":
            return exc.ActorDiedError(blob.get("message", ""))
        if etype == "TaskCancelledError":
            return exc.TaskCancelledError(blob.get("message", "task cancelled"))
        if etype == "TaskTimeoutError":
            return exc.TaskTimeoutError(blob.get("message", "task exceeded its timeout_s"))
        if etype == "ObjectLostError":
            return exc.ObjectLostError(blob.get("message", "object lost"))
        return exc.RayTpuError(str(blob))

    # ---------------------------------------------------------------- wait
    def wait(self, refs: list[ObjectRef], num_returns: int = 1, timeout: float | None = None):
        """Event-driven wait (reference raylet/wait_manager.h is similarly
        notification-based): owned refs hook resolution watchers and sleep on
        one Event — no polling, no controller traffic. Only refs owned by
        ANOTHER process (no local resolution slot) fall back to polling the
        controller's bulk readiness probe."""
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list[ObjectRef] = []
        owned_pending: list[ObjectRef] = []
        borrowed_pending: list[ObjectRef] = []
        for r in refs:
            oid = r.hex()
            if self._is_ready_local(oid):
                ready.append(r)
            elif oid in self._resolutions:
                owned_pending.append(r)
            else:
                borrowed_pending.append(r)
        if len(ready) >= num_returns or not (owned_pending or borrowed_pending):
            return ready, owned_pending + borrowed_pending
        ev = threading.Event()
        hits: list[ObjectRef] = []
        hits_lock = threading.Lock()
        live = [True]  # watchers outlive this call; dead-man switch

        def _mk_cb(r):
            def cb():
                if live[0]:
                    with hits_lock:
                        hits.append(r)
                    ev.set()
            return cb

        registered: list[tuple] = []  # (res, cb) to deregister on exit
        try:
            for r in owned_pending:
                res = self._resolutions.get(r.hex())
                cb = _mk_cb(r)
                if res is None or not res.add_watcher(cb):
                    cb()  # resolved between classification and registration
                else:
                    registered.append((res, cb))
            owned_waiting = set(owned_pending)
            while True:
                with hits_lock:
                    newly, hits[:] = list(hits), []
                for r in newly:
                    if r in owned_waiting:
                        owned_waiting.discard(r)
                        ready.append(r)
                if len(ready) >= num_returns or not (owned_waiting or borrowed_pending):
                    break
                if borrowed_pending:
                    oids = [r.hex() for r in borrowed_pending]
                    rep = self.io.run(self.controller.call("check_objects", oids=oids))
                    newly_b = [r for r, ok in zip(borrowed_pending, rep["ready"]) if ok]
                    ready.extend(newly_b)
                    borrowed_pending = [
                        r for r, ok in zip(borrowed_pending, rep["ready"]) if not ok]
                    if len(ready) >= num_returns or not (owned_waiting or borrowed_pending):
                        break
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    break
                # With borrowed refs in play we must re-poll the controller;
                # otherwise sleep until a watcher fires (or timeout).
                if borrowed_pending:
                    rem = 0.005 if rem is None else min(rem, 0.005)
                ev.wait(rem)
                ev.clear()
        finally:
            live[0] = False
            # Deregister un-fired watchers: a caller polling wait() in a
            # loop against a slow task must not grow the resolution's
            # watcher list (and pin refs) on every call.
            for res, cb in registered:
                res.remove_watcher(cb)
        return ready, [r for r in owned_pending if r in owned_waiting] + borrowed_pending

    def _is_ready_local(self, oid: str) -> bool:
        if oid in self._inline_cache or self.store.contains(oid):
            return True
        res = self._resolutions.get(oid)
        return res is not None and res.done

    # ------------------------------------------------- streaming generators
    def _gen_new(self, spec: TaskSpec) -> "ObjectRefGenerator":
        """Register owner-side stream state for a streaming spec (whose
        completion resolution must already exist) and return the public
        generator object."""
        comp_oid = spec.return_object_ids()[0]
        thresh = CONFIG.generator_backpressure_items
        # stride 0 = backpressure disabled: send no acks at all (the
        # executor ignores them anyway).
        stride = max(1, thresh // 4) if thresh > 0 else 0
        gs = _GenState(spec.task_id, stride)
        self._generators[spec.task_id] = gs
        res = self._resolutions[comp_oid]

        def _fin():
            total, err = None, res.error
            if err is None and res.inline is not None:
                try:
                    blob = (res.inline[0] if len(res.inline) == 1
                            else b"".join(bytes(p) for p in res.inline))
                    total = int(self._deserialize_blob(memoryview(blob)))
                except Exception:
                    total = None
            gs.finish(total, err)

        if not res.add_watcher(_fin):
            _fin()
        return ObjectRefGenerator(
            self, spec.task_id, ObjectRef(comp_oid, owned=True, worker=self))

    def _on_gen_items(self, conn, items):
        """Incremental item reports from the executing worker (runs on the
        IO loop; reference ReportGeneratorItemReturns handler). A retry
        re-reports indices the owner already has — re-resolve (idempotent)
        but never re-queue."""
        closed: set[str] = set()
        for tid, idx, result in items:
            oid, inline, size, holder = result
            gs = self._generators.get(tid)
            if gs is None:
                # Generator destroyed before the stream drained: drop the
                # straggler and tell the executor to stop producing (its
                # backpressure wait would otherwise never end — actor-task
                # streams have no lease/controller cancel path).
                res = self._resolutions.setdefault(oid, _Resolution())
                res.resolve(inline, [tuple(holder)] if holder else [], None)
                self._free([oid])
                closed.add(tid)
                continue
            with gs.cond:
                gs.conn = conn
                fresh = idx >= gs.produced
                if fresh:
                    gs.produced = idx + 1
            if fresh:
                res = self._resolutions.setdefault(oid, _Resolution())
                res.resolve(inline, [tuple(holder)] if holder else [], None)
                with gs.cond:
                    gs.queue.append(oid)
                    gs.cond.notify_all()
                if self._generators.get(tid) is not gs:
                    # _gen_destroy ran between our registry fetch and the
                    # append: its queue-snapshot free missed this item, so
                    # drain-and-free here (double free is idempotent).
                    with gs.cond:
                        orphaned = list(gs.queue)
                        gs.queue.clear()
                    if orphaned:
                        self._free(orphaned)
                    closed.add(tid)
            else:
                # Retry re-report of an index we already have. Re-resolve
                # ONLY if the resolution still exists (a live ref or queued
                # item) — recreating one for a consumed-and-freed item would
                # leak it forever.
                res = self._resolutions.get(oid)
                if res is not None:
                    res.resolve(inline, [tuple(holder)] if holder else [], None)
        for tid in closed:
            try:
                conn.push_threadsafe("gen_close", task_id=tid)
            except Exception:
                pass

    def _gen_conn_lost(self, conn):
        """Called by the lease manager / actor pipe when a connection that
        carried stream items closes: truncate any stream whose trailing
        items were provably lost (see _GenState.conn_lost). Streams whose
        spec is still tracked (retry/fail) are handled by those paths."""
        # conn is None: a completed stream that never received items on ANY
        # connection (e.g. the completion landed but the executor died
        # before flushing items) must still be truncated — conn_lost()
        # itself requires done && produced < total, so fresh streams on
        # other connections are untouched.
        gens = [gs for gs in self._generators.values()
                if gs.conn is conn or (gs.conn is None and gs.done)]
        if not gens:
            return
        h, bufs = dumps_oob({
            "type": "WorkerCrashedError",
            "message": "stream truncated: executor connection lost with "
                       "trailing items undelivered"})
        for gs in gens:
            gs.conn_lost([h, *bufs])

    def _gen_destroy(self, task_id: str):
        """Generator object GC'd: free unconsumed items, cancel a stream
        still in flight (reference: deleting the generator cancels the task
        and GCs unconsumed returns)."""
        gs = self._generators.pop(task_id, None)
        if gs is None or self._shutdown:
            return
        with gs.cond:
            pending = list(gs.queue)
            gs.queue.clear()
            done = gs.done
            conn = gs.conn
        if pending:
            try:
                self._free(pending)
            except Exception:
                pass
        if not done and conn is not None:
            # Direct stop signal to the executor: actor-task streams have no
            # cancel path through the lease manager or controller, and the
            # producer may be parked in a backpressure wait.
            try:
                conn.push_threadsafe("gen_close", task_id=task_id)
            except Exception:
                pass
        if not done:
            # cancel_task blocks on the IO loop; __del__ may run on any
            # thread (including the loop itself), so hop to a helper thread.
            def _bg():
                try:
                    self.cancel_task(task_id, False)
                except Exception:
                    pass

            threading.Thread(target=_bg, daemon=True,
                             name="rt-gen-cancel").start()

    # --------------------------------------------------------- submit task
    def _register_function(self, fn) -> str:
        # Hot path: serializing the function (closure walk) costs far more
        # than the submit itself — cache by object identity so a @remote
        # function is pickled once per process (reference function_manager
        # exports once per function id).
        try:
            fid = self._fn_id_cache.get(fn)
        except TypeError:  # unhashable/unweakrefable callables: no cache
            fid = None
        if fid is not None:
            return fid
        blob = serialize(fn, ref_class=ObjectRef)
        if blob.contained_refs:
            raise ValueError("remote function may not close over ObjectRefs; pass them as args")
        data = blob.to_bytes()
        import hashlib

        fid = hashlib.sha1(data).hexdigest()
        if fid not in self._registered_fns:
            self.io.run(self.controller.call("kv_put", ns="fn", key=fid, value=data, overwrite=False))
            self._registered_fns.add(fid)
        try:
            self._fn_id_cache[fn] = fid
        except TypeError:
            pass
        return fid

    def load_function(self, fid: str):
        fn = self._fn_cache.get(fid)
        if fn is None:
            rep = self.io.run(self.controller.call("kv_get", ns="fn", key=fid))
            if rep["value"] is None:
                raise exc.RayTpuError(f"function {fid} not found in KV")
            sobj = SerializedObject.from_buffer(memoryview(rep["value"]))
            fn = self._deser_with_refs(sobj)
            self._fn_cache[fid] = fn
        return fn

    def _encode_args(self, args, kwargs):
        """Returns (enc_args, enc_kwargs, escaping_oids, dref_oids).
        escaping_oids are the refs shipped inside this payload — the
        submitter must PIN the owned ones until the task completes
        (reference: task arguments hold references, reference_count.h
        AddLocalReference for args), or rebinding the Python variable frees
        the arg before the worker can read it. dref_oids are device-plane
        arg promotions, holding one refcount from _encode_one that the
        submit path must tie to the task's return ref (_register_arg_pins)
        or the pinned device memory outlives every reference to it."""
        escapes: list[str] = []
        drefs: list[str] = []
        enc_args = [self._encode_one(a, escapes, drefs) for a in args]
        enc_kwargs = {k: self._encode_one(v, escapes, drefs)
                      for k, v in kwargs.items()}
        return enc_args, enc_kwargs, escapes, drefs

    def _encode_one(self, value, escapes: list | None = None,
                    drefs: list | None = None):
        if isinstance(value, ObjectRef):
            oid = value.hex()
            self._advertise_escaping([oid])
            if escapes is not None:
                escapes.append(oid)
            return ("ref", oid)
        if device_store.eligible(value):
            # Large device-array argument: pin instead of copying through
            # the host store; the placeholder blob rides INSIDE the spec
            # (task_spec.DEVICE_REF) so the executor resolves it from the
            # location hint with no controller round trip. The incref is
            # the submit-time hold; _register_arg_pins drops it when the
            # task's return ref dies.
            oid, blob = self._put_device(value)
            self._incref(oid)
            if drefs is not None:
                drefs.append(oid)
            return (DEVICE_REF, oid, blob)
        sobj = serialize(value, ref_class=ObjectRef)
        if sobj.contained_refs:
            oids = [r.hex() if isinstance(r, ObjectRef) else r
                    for r in sobj.contained_refs]
            self._advertise_escaping(oids)
            if escapes is not None:
                escapes.extend(oids)
        if sobj.total_bytes() <= CONFIG.max_inline_object_bytes:
            return ("v", sobj.to_bytes())
        # Large argument: promote to an owned object (reference puts >100KB
        # args in plasma — remote_function.py _remote).
        oid = ObjectID.from_put().hex()
        self._store_blob(oid, sobj, register=True)
        self._incref(oid)  # pinned for the duration of the session put
        return ("ref", oid)

    def _pin_args_until_done(self, escapes: list[str], refs: list):
        """incref owned arg refs now; decref when the task's first return
        resolves (value, error, or cancellation all resolve)."""
        if not escapes or not refs:
            return
        pinned = [o for o in escapes if o in self._refcounts]
        if not pinned:
            return
        for o in pinned:
            self._incref(o)
        res = self._resolutions.get(refs[0].hex())
        if res is None:
            for o in pinned:
                self._decref(o)
            return
        def _unpin(_pinned=tuple(pinned)):
            for o in _pinned:
                self._decref(o)

        if not res.add_watcher(_unpin):
            _unpin()  # already resolved

    def _register_arg_pins(self, drefs: list[str], refs: list):
        """Tie device-arg pins to the task's return refs: one hold per
        return ref (the _encode_one incref covers the first; extras are
        taken here), dropped as each ref is freed — so the pins outlive
        any window where ANY result could still be lineage-reconstructed
        (reconstruction re-runs the spec, which re-resolves the dref blobs
        from this table), without holding device memory for the whole
        session. No refs (fire-and-forget num_returns=0) keeps the session
        hold — nothing observable ever says the task is done."""
        if not drefs or not refs:
            return
        for i, r in enumerate(refs):
            if i > 0:
                for o in drefs:
                    self._incref(o)
            key = r.hex()
            prev = self._arg_pins.get(key)
            self._arg_pins[key] = ((tuple(prev) + tuple(drefs)) if prev
                                   else tuple(drefs))

    def _advertise_escaping(self, oids: list[str]):
        """Owner-side escape analysis at the serialization boundary: a ref
        can only be BORROWED after its owner ships it inside a payload, so
        inline results (which are no longer eagerly advertised on the
        direct-call paths) are registered with the controller exactly when
        they first escape. Shm results and puts are advertised at creation
        (they name a fetchable holder); borrowed refs are skipped (their
        owner advertised them before they reached us)."""
        for oid in oids:
            if oid in self._escaped:
                continue
            res = self._resolutions.get(oid)
            if res is None:
                continue  # not ours
            self._escaped.add(oid)
            cb = (lambda o=oid, r=res: self._push_escape_advertise(o, r))
            if not res.add_watcher(cb):
                cb()  # already resolved: advertise now

    def _push_escape_advertise(self, oid: str, res: "_Resolution"):
        if res.inline is None and res.error is None:
            return  # shm result: the executing worker advertised the holder
        size = sum(len(p) for p in res.inline) if res.inline else 0
        try:
            self.controller.push_threadsafe(
                "register_put", oid=oid, size=size, inline=res.inline,
                holder=None, owner=self.worker_id, error=res.error)
        except Exception:
            pass

    def decode_args(self, enc_args, enc_kwargs):
        if not enc_args and not enc_kwargs:
            return (), {}
        args = [self._decode_one(e) for e in enc_args]
        kwargs = {k: self._decode_one(e) for k, e in enc_kwargs.items()}
        return args, kwargs

    def _decode_one(self, e):
        kind = e[0]
        if kind == "ref":
            return self._get_one(ObjectRef(e[1]), deadline=None)
        if kind == DEVICE_REF:
            # Device-plane argument: the placeholder carries its own
            # location hint — deserializing resolves through the tier
            # ladder directly (no wait_object round trip).
            return self._deserialize_blob(memoryview(e[2]))
        return self._deserialize_blob(memoryview(e[1]))

    def submit_task(self, fn, args, kwargs, *, name=None, num_returns=1, resources: ResourceSet,
                    strategy: SchedulingStrategy | None = None, max_retries: int | None = None,
                    retry_exceptions=False, runtime_env=None,
                    timeout_s: float | None = None) -> list[ObjectRef]:
        streaming = num_returns == STREAMING
        if streaming and any(k.startswith("GPU") for k in resources.raw()):
            raise ValueError(
                "num_returns='streaming' tasks ride the direct lease path; "
                "GPU tasks use controller dispatch. Host a streaming method "
                "on a GPU actor instead.")
        if runtime_env:
            from ray_tpu_torch._private import runtime_env as _rtenv

            runtime_env = _rtenv.package(self, runtime_env)
        fid = self._register_function(fn)
        enc_args, enc_kwargs, escapes, drefs = (
            self._encode_args(args, kwargs)
            if (args or kwargs) else ([], {}, [], []))
        task_id = TaskID.from_random().hex()
        spec = TaskSpec(
            task_id=task_id,
            kind=NORMAL,
            name=name or getattr(fn, "__name__", "task"),
            function_id=fid,
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=num_returns,
            resources=resources.raw(),
            strategy=strategy or SchedulingStrategy(),
            max_retries=CONFIG.default_max_task_retries if max_retries is None else max_retries,
            retry_exceptions=retry_exceptions,
            runtime_env=runtime_env or {},
            owner_id=self.worker_id,
            owner_addr=self.server_addr,
            timeout_s=timeout_s,
        )
        if _tracing.enabled():
            # Submit span + wire context: inside a traced task this chains
            # to the executing span; at top level it roots a new trace
            # (head-based RT_TRACE_SAMPLE decision).
            spec.trace = _tracing.on_submit(spec.name, task_id)
        refs = []
        for oid in spec.return_object_ids():
            self._resolutions[oid] = _Resolution()
            # Streaming tasks retry via lease requeue, not lineage: the
            # controller-dispatch reconstruction path has no item transport.
            if spec.max_retries != 0 and not streaming:
                self._lineage[oid] = spec
            refs.append(ObjectRef(oid, owned=True, worker=self))
        # drefs ride the until-done pin too: a fire-and-forget caller drops
        # the result ref instantly, and without the completion hold the
        # per-ref release would free the pinned arg before the executor
        # decodes it (the host path gets this from the same call).
        self._pin_args_until_done(escapes + drefs, refs)
        self._register_arg_pins(drefs, refs)
        if streaming:
            # Streaming always rides the direct path (the controller
            # transport has no item stream), RT_DIRECT_DISPATCH or not.
            gen = self._gen_new(spec)
            self.lease_mgr.submit(spec)
            return gen
        # Direct path: lease workers by scheduling class and stream specs to
        # them (reference NormalTaskSubmitter lease pools). GPU tasks keep
        # the controller-dispatch path — they need a dedicated worker whose
        # card lease dies with the process. RT_DIRECT_DISPATCH=0 routes
        # everything through the controller (the classic path; also the
        # perf-gate comparison workload).
        if (CONFIG.direct_dispatch
                and not any(k.startswith("GPU") for k in spec.resources)):
            self.lease_mgr.submit(spec)
            return refs
        self.submit_specs_via_controller([spec])
        return refs

    def submit_specs_via_controller(self, specs: list):
        """Queue already-built specs on the classic controller dispatch
        path (GPU tasks, RT_DIRECT_DISPATCH=0, and direct-dispatch
        failover). Thread-safe; bursts coalesce into one `submit_tasks`
        frame via the flusher."""
        _record_dispatch("controller", len(specs))
        # Coalesced submit: bursts of .remote() calls ride one RPC frame
        # (reference batches task submission through the Cython layer; here
        # the flusher drains whatever accumulated while the previous frame
        # was in flight).
        with self._submit_lock:
            self._submit_buf.extend(specs)
            need_flush = not self._submit_flushing
            self._submit_flushing = True
        if need_flush:
            self.io.spawn(self._a_flush_submits())

    def cancel_task(self, task_id: str, force: bool):
        """Cancel a task wherever it lives: the owner's lease pipelines (the
        direct path) or the controller queue (GPU/legacy/reconstruction)."""
        if self.lease_mgr.cancel(task_id, force):
            return {"status": "cancelled_direct"}
        return self.io.run(self.controller.call(
            "cancel_task", task_id=task_id, force=force))

    async def _a_flush_submits(self):
        while True:
            with self._submit_lock:
                batch = list(self._submit_buf)
                self._submit_buf.clear()
                if not batch:
                    self._submit_flushing = False
                    return
            try:
                # Acked call, not a push: with coalesced writes a push
                # "succeeds" once buffered, so a connection dying before
                # the flush would silently strand the batch's refs forever.
                # One round-trip per BATCH keeps the ack off the per-task
                # cost.
                await self.controller.call("submit_tasks", specs=batch)
            except Exception as e:
                # The push failed after the specs left the buffer: fail the
                # batch's refs so callers see an error instead of a hang —
                # including anything that accumulated while the push was in
                # flight (no new flusher was spawned for those specs).
                with self._submit_lock:
                    batch.extend(self._submit_buf)
                    self._submit_buf.clear()
                    self._submit_flushing = False
                h, bufs = dumps_oob({"type": "WorkerCrashedError",
                                     "message": f"task submission failed: {e}"})
                for spec in batch:
                    for oid in spec.return_object_ids():
                        res = self._resolutions.setdefault(oid, _Resolution())
                        res.resolve(None, [], [h, *bufs])
                return

    # -------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, *, name=None, namespace="default",
                     get_if_exists=False, resources: ResourceSet,
                     strategy: SchedulingStrategy | None = None, max_restarts=0,
                     max_task_retries=0, max_concurrency=1, runtime_env=None,
                     actor_display_name=None, lifetime=None,
                     concurrency_groups=None) -> str:
        from ray_tpu_torch._private.ids import ActorID

        if runtime_env:
            from ray_tpu_torch._private import runtime_env as _rtenv

            runtime_env = _rtenv.package(self, runtime_env)
        fid = self._register_function(cls)
        enc_args, enc_kwargs, escapes, _drefs = self._encode_args(args, kwargs)
        # Actor init args must survive RESTARTS (the controller re-runs
        # __init__ from the same spec), so owned arg refs stay pinned for
        # the session (reference: the GCS holds actor creation specs) —
        # device-arg pins (_drefs) keep their session hold for the same
        # reason: a restart re-resolves them from the submitter's table.
        for o in escapes:
            if o in self._refcounts:
                self._incref(o)
        actor_id = ActorID.from_random().hex()
        spec = TaskSpec(
            task_id=TaskID.from_random().hex(),
            kind=ACTOR_CREATE,
            name=actor_display_name or getattr(cls, "__name__", "actor"),
            function_id=fid,
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=0,
            resources=resources.raw(),
            strategy=strategy or SchedulingStrategy(),
            runtime_env=runtime_env or {},
            owner_id=self.worker_id,
            owner_addr=self.server_addr,
            actor_id=actor_id,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            actor_name=name,
            namespace=namespace,
            get_if_exists=get_if_exists,
            lifetime=lifetime,
            concurrency_groups=dict(concurrency_groups) if concurrency_groups else None,
        )
        if _tracing.enabled():
            spec.trace = _tracing.on_submit(spec.name, spec.task_id)
        rep = self.io.run(self.controller.call("create_actor", spec=spec))
        return rep["actor_id"]

    async def _a_resolve_actor(self, actor_id: str, wait=True, timeout=60.0) -> dict:
        info = self._actor_info.get(actor_id)
        if info is not None and info.get("state") == "ALIVE":
            return info
        rep = await self.controller.call(
            "get_actor_info", actor_id=actor_id, wait=wait, timeout=timeout)
        if rep["status"] != "ok":
            raise exc.ActorDiedError(f"actor {actor_id[:12]} not found")
        if rep["state"] == "DEAD":
            if rep.get("death_cause"):
                raise self._decode_error(rep["death_cause"])
            raise exc.ActorDiedError(f"actor {actor_id[:12]} is dead")
        self._actor_info[actor_id] = rep
        return rep


    def submit_actor_task(self, actor_id: str, method_name: str, args, kwargs, *,
                          num_returns=1, name=None, max_task_retries=0) -> list[ObjectRef]:
        enc_args, enc_kwargs, escapes, drefs = (
            self._encode_args(args, kwargs)
            if (args or kwargs) else ([], {}, [], []))
        task_id = TaskID.from_random().hex()
        spec = TaskSpec.for_actor_call(
            task_id, method_name, enc_args, enc_kwargs, num_returns,
            name or method_name, self.worker_id, self.server_addr, actor_id)
        if _tracing.enabled():
            spec.trace = _tracing.on_submit(spec.name, task_id)
        refs = []
        for oid in spec.return_object_ids():
            self._resolutions[oid] = _Resolution()
            refs.append(ObjectRef(oid, owned=True, worker=self))
        if escapes or drefs:
            # drefs included: the completion hold keeps a fire-and-forget
            # call's pinned args alive until the executor is done with them
            # (see submit_task).
            self._pin_args_until_done(escapes + drefs, refs)
        self._register_arg_pins(drefs, refs)
        gen = self._gen_new(spec) if num_returns == STREAMING else None
        pipe = self._actor_pipes.get(actor_id)
        if pipe is None:
            with self._submit_lock:
                pipe = self._actor_pipes.get(actor_id)
                if pipe is None:
                    pipe = self._actor_pipes[actor_id] = _ActorPipe(self, actor_id)
        pipe.submit(spec, max(0, max_task_retries))
        return gen if gen is not None else refs

    def _fail_actor_call(self, spec: TaskSpec, e: Exception):
        blob = {"type": "ActorDiedError", "message": str(e)}
        if isinstance(e, exc.TaskError):
            blob = {"type": "TaskError", "function_name": spec.name,
                    "traceback": str(e), "cause": None}
        h, bufs = dumps_oob(blob)
        for oid in spec.return_object_ids():
            res = self._resolutions.setdefault(oid, _Resolution())
            res.resolve(None, [], [h, *bufs])

    def _apply_actor_reply(self, spec: TaskSpec, rep: tuple):
        # rep: (task_id, attempt, results, error, retryable, exec_failure)
        _tid, _attempt, results, error, _retryable, exec_failure = rep  # rtcheck: wire=tasks_done.item
        if spec.trace is not None:
            _tracing.record_instant(
                spec.trace, "result", "result",
                {"task": spec.task_id, "ok": error is None})
        if exec_failure and not results:
            # The actor's executor layer failed before results were packaged:
            # fail the refs rather than leaving the caller blocked forever.
            self._fail_actor_call(spec, exc.ActorUnavailableError(
                f"actor executor failure: {exec_failure}"))
            return
        for oid, inline, size, holder in results or ():
            res = self._resolutions.setdefault(oid, _Resolution())
            res.resolve(inline, [tuple(holder)] if holder else [], error)

    def _schedule_pipe_pump(self, pipe: "_ActorPipe"):
        """Coalesced cross-thread pump scheduling for actor pipes (see
        _pump_pipes). Called from any thread with pipe.pumping already
        claimed by the caller."""
        with self._submit_lock:
            self._pump_pipes.append(pipe)
            if self._pipe_pump_scheduled:
                return
            self._pipe_pump_scheduled = True
        self.io.spawn(self._a_pump_pipes())

    async def _a_pump_pipes(self):
        while True:
            with self._submit_lock:
                pipes, self._pump_pipes = self._pump_pipes, []
                if not pipes:
                    self._pipe_pump_scheduled = False
                    return
            for pipe in pipes:
                # Fan out ON the loop: one pipe's slow connect must not
                # stall its siblings' flushes.
                asyncio.ensure_future(pipe._a_pump())

    def kill_actor(self, actor_id: str, no_restart=True):
        self.io.run(self.controller.call("kill_actor", actor_id=actor_id, no_restart=no_restart))
        self._actor_info.pop(actor_id, None)

    # ------------------------------------------------------------- cluster
    def cluster_resources(self) -> dict:
        return self.io.run(self.controller.call("cluster_resources"))

    def state_snapshot(self) -> dict:
        return self.io.run(self.controller.call("state_snapshot"))

    def kv(self, op: str, **kw):
        return self.io.run(self.controller.call(f"kv_{op}", **kw))


class _ActorPipe:
    """Ordered, pipelined transport to one actor.

    Bursts of calls ride coalesced `actor_tasks` frames; replies come back
    as batched `tasks_done` pushes keyed by task_id (so out-of-order
    completion from async/threaded actors resolves correctly). On connection
    loss, in-flight calls with retries left are resubmitted IN ORDER across
    the actor restart; the rest fail with ActorDiedError (reference
    ActorTaskSubmitter restart semantics)."""

    __slots__ = ("w", "actor_id", "lock", "queue", "inflight", "seq", "conn",
                 "pumping")

    def __init__(self, worker: "Worker", actor_id: str):
        self.w = worker
        self.actor_id = actor_id
        self.lock = threading.Lock()
        self.queue: deque = deque()
        self.inflight: dict[str, tuple] = {}  # task_id -> (spec, retries, seq)
        self.seq = 0
        self.conn = None
        self.pumping = False

    def submit(self, spec: TaskSpec, retries: int):
        with self.lock:
            self.seq += 1
            self.queue.append((spec, retries, self.seq))
            need = not self.pumping
            self.pumping = True
        if need:
            self.w._schedule_pipe_pump(self)

    async def _a_pump(self):
        while True:
            if self.conn is None or self.conn.closed:
                if not await self._a_connect():
                    return  # everything failed; pumping reset by _a_connect
            with self.lock:
                batch = list(self.queue)
                self.queue.clear()
                if not batch:
                    self.pumping = False
                    return
            for spec, retries, seq in batch:
                self.inflight[spec.task_id] = (spec, retries, seq)
            try:
                # Compact wire form: frame-constant owner/actor fields ride
                # once, per-call fields as tuples (~3x cheaper than full
                # 24-field spec pickles at n:n call rates).
                await self.conn.push(
                    "actor_calls",
                    common=(self.w.worker_id, self.w.server_addr, self.actor_id),
                    calls=[b[0].actor_call_tuple() for b in batch])
            except Exception:
                pass  # close handler redistributes inflight; loop reconnects

    async def _a_connect(self) -> bool:
        attempts = 0
        while True:
            try:
                info = await self.w._a_resolve_actor(self.actor_id)
                if info.get("address") is None:
                    # Still PENDING (creation queued/scheduling — on a
                    # loaded cluster a big actor wave can take minutes):
                    # calls QUEUE until the actor lands (reference actor
                    # task submitter buffers until the actor is ready).
                    # A dead actor raises from _a_resolve_actor instead.
                    self.w._actor_info.pop(self.actor_id, None)
                    await asyncio.sleep(0.5)
                    continue
                conn = await rpc.connect(
                    *info["address"], on_push=self._on_push,
                    on_close=self._on_close, timeout=10,
                    label="actor-pipe")
                # A new worker may have reused a dead worker's port while the
                # controller still reports the old instance ALIVE: verify
                # identity before trusting the link.
                expect = info.get("worker_id")
                if expect is not None:
                    rep = await conn.call("whoami", _timeout=10)
                    if rep.get("worker_id") != expect:
                        await conn.close()
                        raise ConnectionError("stale actor address (port reused)")
                self.conn = conn
                return True
            except (exc.ActorError, exc.TaskError) as e:
                self._fail_all(e)
                return False
            except Exception as e:
                # Stale address / refused connection: the actor may be
                # mid-restart and not re-registered yet — re-resolve.
                self.w._actor_info.pop(self.actor_id, None)
                attempts += 1
                if attempts > 20:
                    self._fail_all(e, permanent=False)
                    return False
                await asyncio.sleep(0.1)

    def _fail_all(self, e: Exception, permanent: bool = True):
        with self.lock:
            q = list(self.queue)
            self.queue.clear()
            self.pumping = False
        inf = sorted(self.inflight.values(), key=lambda t: t[2])
        self.inflight.clear()
        for spec, _, _ in inf:
            self.w._fail_actor_call(spec, e)
        for spec, _, _ in q:
            self.w._fail_actor_call(spec, e)
        if permanent:
            # Keep the pipe reusable: a later submit re-resolves the actor
            # (named get_if_exists / restarted handles), failing fast again
            # if it is still dead.
            self.w._actor_info.pop(self.actor_id, None)

    async def _on_push(self, conn, method, a):
        if method == "gen_items":
            self.w._on_gen_items(conn, a["items"])
            return
        if method != "tasks_done":
            return
        for item in a["done"]:
            ent = self.inflight.pop(item[0], None)  # rtcheck: wire=tasks_done.item
            if ent is None:
                continue
            self.w._apply_actor_reply(ent[0], item)

    def _on_close(self, conn):
        if self.conn is not conn:
            return
        self.conn = None
        if self.w._shutdown:
            return
        self.w._gen_conn_lost(conn)
        self.w._actor_info.pop(self.actor_id, None)
        # Redistribute in-flight calls: retryable ones go back to the FRONT
        # of the queue in sequence order; the rest fail now.
        inf = sorted(self.inflight.values(), key=lambda t: t[2])
        self.inflight.clear()
        with self.lock:
            for spec, retries, seq in reversed(inf):
                if retries > 0:
                    self.queue.appendleft((spec, retries - 1, seq))
            need = bool(self.queue) and not self.pumping
            if need:
                self.pumping = True
        for spec, retries, _ in inf:
            if retries <= 0:
                self.w._fail_actor_call(spec, exc.ActorDiedError(
                    f"actor {self.actor_id[:12]} died mid-call"))
        if need:
            self.w.io.spawn(self._a_pump())

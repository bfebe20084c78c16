"""Worker process entrypoint: executes tasks and hosts actors.

Parity target: the reference's task execution path — TaskReceiver
(core_worker/transport/task_receiver.h:51) + the Cython callback chain
(_raylet.pyx:2268 task_execution_handler ->
execute_task_with_cancellation_handler :2078): deserialize args, run the user
function, serialize/store returns (small inline, large to the shm store).
Actor calls arrive directly from callers on this process's RPC server
(reference direct actor transport) and execute in arrival order on the single
execution thread (reference sequential_actor_submit_queue.h).

Counterpart: ray_tpu/_private/worker_proc.py (copied; the device profile
mode is "torch").
"""

from __future__ import annotations

import asyncio
import ctypes
import inspect
import logging
import os
import queue
import sys
import threading
import time
import traceback

from ray_tpu_torch._private import device_store, rpc, watchdog
from ray_tpu_torch._private import telemetry as _telemetry
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private import runtime_env as _rtenv
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch._private.serialization import dumps_oob, serialize
from ray_tpu_torch._private.task_spec import ACTOR_CREATE, ACTOR_TASK, NORMAL, STREAMING, TaskSpec
from ray_tpu_torch._private.worker import ObjectRef, Worker, set_global_worker

logger = logging.getLogger(__name__)


class _BatchPusher:
    """Thread-safe coalescing pusher: .add() from any thread, frames drain on
    the connection's loop — bursts of per-task messages ride few frames
    (mirrors the submit-side flusher in Worker._a_flush_submits)."""

    def __init__(self, conn, method: str, field: str):
        self.conn = conn
        self.method = method
        self.field = field
        self._buf: list = []
        self._lock = threading.Lock()
        self._flushing = False

    def add(self, item):
        with self._lock:
            self._buf.append(item)
            if self._flushing:
                return
            self._flushing = True
        asyncio.run_coroutine_threadsafe(self._a_flush(), self.conn.loop)

    async def _a_flush(self):
        while True:
            with self._lock:
                batch = self._buf
                self._buf = []
                if not batch:
                    self._flushing = False
                    return
            try:
                await self.conn.push(self.method, **{self.field: batch})
            except Exception:
                with self._lock:
                    self._flushing = False
                return  # peer gone; owner-side failure handling takes over


class WorkerProc:
    def __init__(self):
        self.worker_id = os.environ["RT_WORKER_ID"]
        self.node_id = os.environ["RT_NODE_ID"]
        self.session = os.environ["RT_SESSION"]
        chost, cport = os.environ["RT_CONTROLLER"].rsplit(":", 1)
        ahost, aport = os.environ["RT_AGENT"].rsplit(":", 1)
        self.agent_addr = (ahost, int(aport))
        # The first torch.profiler session's start-up, paid once CUDA is
        # initialised rather than by the first `profile --mode torch`
        # (where the `profiler_prep` flag asks for it).
        self._profiler_prep = _telemetry.TorchProfilerPrep()
        self.worker = Worker(
            mode="worker",
            session_id=self.session,
            controller_addr=(chost, int(cport)),
            node_id=self.node_id,
            agent_addr=self.agent_addr,
            worker_id=self.worker_id,
        )
        self.exec_queue: "queue.Queue" = queue.Queue()
        self.agent_conn: rpc.Connection | None = None
        self.actor_instance = None
        self._method_cache: dict = {}  # method name -> (bound method, is_coro)
        self.actor_id: str | None = None
        self.actor_max_concurrency = 1
        self.actor_concurrency_groups: dict = {}
        self._group_pools: dict = {}
        self._group_budgets: dict = {}
        self._actor_pool = None  # ThreadPoolExecutor for threaded actors
        self._actor_loop = None  # EventLoopThread for async actors
        self._actor_sem: asyncio.Semaphore | None = None
        self._exec_thread_ident: int | None = None
        self._current_task_id: str | None = None
        self._cancel_requested: set[str] = set()  # cancels that beat the task
        # Leased-path specs accepted but not yet started: task_id -> (spec,
        # conn). Lets a cancel that arrives while the exec thread is blocked
        # in an earlier task report the cancellation immediately.
        self._pending_ltasks: dict = {}
        # Owner-failover bookkeeping: when a lease holder's connection
        # closes, its not-yet-started specs are skipped (the owner re-routes
        # them through the controller — running them here would
        # double-execute) and the spec executing RIGHT NOW is reported to
        # the node agent as `ltask_running` so a failover re-dispatch of the
        # same id parks on the agent's dedup record. The lock makes
        # "pending vs executing" atomic against the prune.
        self._skip_ltasks: set[str] = set()
        self._ltask_lock = threading.Lock()
        self._current_ltask: tuple | None = None  # (task_id, attempt, conn)
        # conn -> deque of recently completed direct-path reply payloads:
        # a push "succeeds" once buffered, so a connection dying right
        # after a completion may strand the reply — the prune republishes
        # these to the agent's dedup table so the owner's failover
        # re-dispatch resolves from the record instead of re-executing.
        self._recent_ltasks: dict = {}
        self._done_pushers: dict = {}  # owner conn -> _BatchPusher
        # Streaming generators (executor side): per-conn item pushers and
        # the consumer-ack table driving backpressure.
        self._gen_pushers: dict = {}  # owner conn -> _BatchPusher
        self._gen_acks: dict[str, int] = {}  # task_id -> items consumed
        self._gen_closed: set[str] = set()  # consumer abandoned the stream
        self._gen_cond = threading.Condition()
        self._prefetch_pool = None  # lazy: arg pre-localization threads
        self._event_seq = 0  # event sampling counter (high-rate shedding)
        self._event_win_start = 0.0
        self._event_win_count = 0
        self._advertise_pusher: _BatchPusher | None = None
        # Compiled-DAG loop threads attached to this actor: dag tag ->
        # list of stop events (one per loop; a dag may bind several of
        # this actor's methods). `__rt_dag_cancel__` sets them so a loop
        # parked on a dead upstream's channel exits promptly at teardown.
        self._dag_stops: dict[str, list] = {}
        self._pins_flagged = False  # last device_pins state told to the agent
        self._pins_lock = threading.Lock()  # orders flag updates vs pushes
        self._pid = os.getpid()  # cached: one event record per task must
        # not pay a getpid syscall (worker procs never fork-and-continue)
        # Stall watchdog (README "Stall detection & watchdogs"): started in
        # start() iff any RT_STALL_* stage is enabled. _timed_out marks
        # (task_id, attempt) pairs whose per-attempt timeout_s deadline
        # fired, so the resulting KeyboardInterrupt surfaces as a RETRYABLE
        # TaskTimeoutError instead of a cancellation.
        self._watchdog: watchdog.Watchdog | None = None
        self._timed_out: set[tuple] = set()
        self._current_attempt: int = 0
        self._running = True

    # ------------------------------------------------------------ startup
    def start(self):
        self.worker.connect()
        set_global_worker(self.worker)
        self.worker.actor_push_handler = self._on_actor_push
        self.worker.actor_batch_handler = self._on_actor_batch
        self.worker.task_push_handler = self._on_task_push
        self.worker.task_batch_handler = self._on_task_batch
        self.worker.task_cancel_handler = self._cancel_current
        self.worker.gen_ack_handler = self._on_gen_ack
        self.worker.gen_close_handler = self._on_gen_close
        # Every pin/unpin in this process — task/actor returns, put()s and
        # dref-arg promotions made INSIDE executing user code alike —
        # reports 0<->nonzero residency to the agent (idle-reap exemption).
        device_store.set_pins_listener(self._report_device_pins)

        def _rebind_ctrl_pushers():
            # Controller reconnected under us: the batched pushers hold the
            # OLD (dead) connection — rebind them or every later advertise
            # and task event silently vanishes.
            self._advertise_pusher = _BatchPusher(
                self.worker.controller, "register_puts", "items")
            self._event_pusher = _BatchPusher(
                self.worker.controller, "task_events", "events")

        self.worker.ctrl_reconnected_handler = _rebind_ctrl_pushers

        # Long-lived pool workers serve many lease holders; drop a holder's
        # batched reply pushers when its connection goes away.
        def _prune(conn):
            self._done_pushers.pop(conn, None)
            self._gen_pushers.pop(conn, None)
            # Owner failover: specs from this holder that haven't started
            # must never run here (the owner re-submits them through the
            # controller); the one executing right now is flagged to the
            # agent so the failover re-dispatch dedups on it.
            running = None
            with self._ltask_lock:
                for tid, (spec_, c) in list(self._pending_ltasks.items()):
                    if c is conn:
                        self._pending_ltasks.pop(tid, None)
                        self._skip_ltasks.add(tid)
                cur = self._current_ltask
                if cur is not None and cur[2] is conn:
                    running = cur[:2]
            if running is not None and self.agent_conn is not None:
                try:
                    self.agent_conn.push_threadsafe(
                        "ltask_running", task_id=running[0],
                        attempt=running[1], worker_id=self.worker_id)
                except Exception:
                    pass
            with self._ltask_lock:
                recent = self._recent_ltasks.pop(conn, None)
            if recent:
                self._report_orphaned(list(recent))
            with self._gen_cond:
                self._gen_cond.notify_all()  # unblock backpressure waits

        self.worker.server_close_handler = _prune
        self._advertise_pusher = _BatchPusher(
            self.worker.controller, "register_puts", "items")
        # Task events -> controller (reference task_event_buffer.h role):
        # one-way batched frames feeding the timeline + state APIs.
        self._event_pusher = _BatchPusher(
            self.worker.controller, "task_events", "events")

        async def _join_agent():
            self.agent_conn = await rpc.connect(
                *self.agent_addr,
                on_request=self._on_agent_request,
                on_push=self._on_agent_push,
                on_close=lambda c: os._exit(0) if self._running else None,
            )
            await self.agent_conn.call(
                "register_worker", worker_id=self.worker_id, address=self.worker.server_addr
            )

        self.worker.io.run(_join_agent(), timeout=CONFIG.connect_timeout_s)
        # Telemetry sampler (README "Telemetry & profiling"): device-side
        # series (CUDA memory, device-object bytes) pushed to
        # the agent each tick. RT_TELEMETRY_INTERVAL_S unset => no thread,
        # nothing pushed — byte-identical off, pinned by test.
        if _telemetry.interval_s() > 0:
            self._telem_sampler = _telemetry.WorkerSampler(
                push=lambda series: self.agent_conn.push_threadsafe(
                    "worker_telemetry", worker_id=self.worker_id,
                    series=series),
                interval=_telemetry.interval_s())
            self._telem_sampler.start()
        # Stall watchdog: monitors every executing task's progress beacon
        # and walks the warn -> dump -> kill ladder through the node agent.
        # With all RT_STALL_* stages unset, start() is a no-op (no thread,
        # no beacons) — escalation-off behavior is byte-identical.
        self._watchdog = watchdog.Watchdog(
            worker_id=self.worker_id, node_id=self.node_id,
            session_id=self.session, on_report=self._push_stall_report,
            on_beacon=self._push_beacon)
        self._watchdog.start()

    def _push_stall_report(self, report: dict) -> bool:
        """Escalation stage crossed (runs on the watchdog thread): hand the
        StallReport to the node agent — it owns stack capture (its per-pid
        dump machinery), the storage-plane flight dump, and the kill.
        Returns False when the hand-off provably failed so the watchdog
        retries the stage next tick instead of marking it emitted."""
        if self.agent_conn is None or self.agent_conn.closed:
            return False
        try:
            self.agent_conn.push_threadsafe("stall_report", report=report)
            return True
        except Exception:
            return False

    def _push_beacon(self, task_id, silence: float):
        """Per-tick progress beacon to the agent. Beacons STOPPING while a
        task executes is itself a signal: the agent-side backstop escalates
        a worker too wedged (GIL held in native code) to self-report."""
        if self.agent_conn is None:
            return
        try:
            self.agent_conn.push_threadsafe(
                "watchdog_beacon", worker_id=self.worker_id,
                task_id=task_id, silence=round(silence, 3))
        except Exception:
            pass

    # ------------------------------------------------- per-attempt timeouts
    def _arm_task_timeout(self, spec: TaskSpec):
        """@remote(timeout_s=): arm the per-attempt execution deadline.
        Enforced HERE (worker-side) so a spinning task is interrupted even
        when its owner is gone; fires the same SIGINT path as cancel, but
        the _timed_out marker reroutes the interrupt into a RETRYABLE
        TaskTimeoutError (system failure under max_retries)."""
        t = getattr(spec, "timeout_s", None)
        if not t or t <= 0:
            return None
        ident = threading.get_ident()

        def _fire():
            # The task may have finished while the timer was in flight: only
            # interrupt the attempt the timer was armed for.
            if (self._current_task_id != spec.task_id
                    or self._current_attempt != spec.attempt):
                return
            self._timed_out.add((spec.task_id, spec.attempt))
            watchdog.record("task_timeout",
                            f"{spec.name} a{spec.attempt} > {t}s")
            try:
                from ray_tpu_torch.util import metrics as _metrics

                _metrics.TASK_TIMEOUTS.inc(1)
            except Exception:
                pass
            if ident == threading.main_thread().ident:
                import signal

                os.kill(os.getpid(), signal.SIGINT)
            else:
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(ident), ctypes.py_object(KeyboardInterrupt))

        timer = threading.Timer(t, _fire)
        timer.daemon = True
        timer.start()
        return timer

    def _consume_timeout(self, spec: TaskSpec, e: BaseException):
        """Returns (error_blob, retryable) when the interrupt was this
        attempt's deadline firing, else None."""
        if not isinstance(e, KeyboardInterrupt):
            return None
        if (spec.task_id, spec.attempt) not in self._timed_out:
            return None
        self._timed_out.discard((spec.task_id, spec.attempt))
        h, bufs = dumps_oob({
            "type": "TaskTimeoutError",
            "message": f"task {spec.name} (attempt {spec.attempt}) exceeded "
                       f"its per-attempt timeout of {spec.timeout_s}s"})
        return [h, *bufs], True

    async def _on_agent_request(self, conn, method, a):
        """Agent->worker requests (the heartbeat/telemetry plane's only
        request path; execution orders stay pushes)."""
        if method == "profile":
            # On-demand capture (README "Telemetry & profiling"). Runs on
            # an executor thread: the capture loop sleeps between samples,
            # and this IO loop keeps carrying beacons/replies meanwhile —
            # which is exactly why a busy worker can be profiled live.
            mode = a.get("mode") or "cpu"
            seconds = _telemetry.clamp_profile_seconds(a.get("seconds"))
            loop = asyncio.get_running_loop()
            if mode == "cpu":
                hz = a.get("hz")
                return await loop.run_in_executor(
                    None, lambda: _telemetry.sample_profile(
                        seconds, int(hz) if hz else None))
            if mode == "torch":
                return await loop.run_in_executor(
                    None, lambda: _telemetry.torch_profile(
                        seconds, self._profiler_prep))
            raise rpc.RpcError(f"unknown profile mode {mode!r}")
        raise rpc.RpcError(f"worker: unknown agent method {method}")

    async def _on_agent_push(self, conn, method, a):
        if method == "execute":
            self.exec_queue.put(("task", a["spec"], None))
        elif method == "cancel":
            self._cancel_current(a["task_id"])
        elif method == "exit":
            self._running = False
            self.exec_queue.put(("exit", None, None))

    def _on_task_push(self, conn, spec: TaskSpec):
        """Direct-path spec from a lease holder (runs on the IO loop)."""
        self._pending_ltasks[spec.task_id] = (spec, conn)
        self.exec_queue.put(("ltask", spec, conn))
        self._prefetch_args(spec)

    def _on_task_batch(self, conn, specs: list):
        """A whole coalesced exec_tasks frame rides ONE exec-queue item."""
        for spec in specs:
            self._pending_ltasks[spec.task_id] = (spec, conn)
        self.exec_queue.put(("ltask_batch", specs, conn))
        for spec in specs:
            self._prefetch_args(spec)

    def _prefetch_args(self, spec: TaskSpec):
        """Pre-localize ref arguments while the spec waits in the exec queue
        (reference dependency_manager.h:55 localizes args BEFORE dispatch;
        without this, fetches serialize inside the task's execution slot)."""
        oids = spec.ref_arg_oids()
        if not oids:
            return
        if self._prefetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="rt-prefetch")

        def _fetch(oid):
            try:
                # Localize bytes only (no deserialization — decode_args does
                # that once, in the exec slot); bounded so a never-resolving
                # ref can't wedge the 2-thread pool forever.
                self.worker.prefetch_object(oid, timeout=120.0)
            except Exception:
                pass

        for oid in oids:
            self._prefetch_pool.submit(_fetch, oid)

    def _report_device_pins(self):
        """device_store pins listener: tell the agent whether this worker
        currently pins device objects (0<->nonzero transitions only) —
        pinned pool workers are exempt from the idle reap, they ARE the
        storage for those objects. The lock orders the stats read, flag
        update and push: a pin on the exec thread racing a device_free on
        the IO thread must not publish transitions out of order (a stale
        trailing pinned=True would exempt an empty worker forever)."""
        if self.agent_conn is None:
            return
        with self._pins_lock:
            pinned = device_store.table_stats()["count"] > 0
            if pinned == self._pins_flagged:
                return
            self._pins_flagged = pinned
            try:
                self.agent_conn.push_threadsafe(
                    "device_pins", worker_id=self.worker_id, pinned=pinned)
            except Exception:
                pass

    def _pusher_for(self, conn) -> "_BatchPusher | None":
        """Per-connection batched reply pusher; None once the holder's
        connection has closed (never re-create an entry for a dead conn —
        its on_close already fired and nothing would ever prune it again)."""
        pusher = self._done_pushers.get(conn)
        if pusher is None and not conn.closed:
            pusher = self._done_pushers[conn] = _BatchPusher(conn, "tasks_done", "done")
            if conn.closed:
                # Raced with the close between the check and the insert: the
                # on_close prune may have already run and found nothing, so
                # prune our own insert (the returned pusher still works — its
                # flush just fails against the dead conn).
                self._done_pushers.pop(conn, None)
        return pusher

    def _on_actor_push(self, conn, spec: TaskSpec):
        """Pipelined actor call (runs on the IO loop): execute in arrival
        order, reply via the per-connection batched pusher."""
        self.exec_queue.put(("actor_batch", [spec], self._pusher_for(conn)))

    def _on_actor_batch(self, conn, specs: list):
        """A whole coalesced actor_calls frame rides ONE exec-queue item:
        at n:n call rates the per-call queue put/get + condition notify was
        a measurable share of the worker's core budget."""
        self.exec_queue.put(("actor_batch", specs, self._pusher_for(conn)))

    def _cancel_current(self, task_id: str):
        """Non-force cancel: raise KeyboardInterrupt in the executing thread
        (reference: ray.cancel() delivers KeyboardInterrupt to the worker's
        main thread, _raylet.pyx execute_task_with_cancellation_handler).
        The exec thread is this process's main thread, so a SIGINT interrupts
        even blocking syscalls (e.g. time.sleep); PyThreadState_SetAsyncExc
        would only fire at the next bytecode boundary."""
        if self._current_task_id != task_id or self._exec_thread_ident is None:
            # The execute push may still be queued ahead of us: remember the
            # cancel so the exec loop aborts the task before running it.
            self._cancel_requested.add(task_id)
            ent = self._pending_ltasks.pop(task_id, None)
            if ent is not None:
                # The spec provably hasn't started and the exec thread may be
                # blocked in a long task ahead of it — report the
                # cancellation NOW (we're on the IO loop) so the owner isn't
                # held hostage by the pipeline head (reference cancels
                # pre-dispatch tasks promptly). The exec loop's own
                # before-start abort later reports again; the owner ignores
                # the duplicate (spec already popped from inflight).
                spec, conn = ent
                h, bufs = dumps_oob({"type": "TaskCancelledError",
                                     "message": f"task {spec.name} cancelled"})
                pusher = self._pusher_for(conn)
                if pusher is not None:
                    pusher.add((spec.task_id, spec.attempt,  # rtcheck: wire=tasks_done.item
                                [(oid, None, 0, None)
                                 for oid in spec.return_object_ids()],
                                [h, *bufs], False, None))
            return
        if self._exec_thread_ident == threading.main_thread().ident:
            import signal

            os.kill(os.getpid(), signal.SIGINT)
        else:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(self._exec_thread_ident), ctypes.py_object(KeyboardInterrupt))

    # ---------------------------------------------------------- exec loop
    def run(self):
        self._exec_thread_ident = threading.get_ident()
        while self._running:
            try:
                kind, spec, reply_slot = self.exec_queue.get()
            except KeyboardInterrupt:
                continue  # late cancel signal; its task already finished
            if kind == "exit":
                break
            try:
                if kind == "ltask":
                    self._execute_leased_task(spec, reply_slot)
                elif kind == "ltask_batch":
                    for sp in spec:
                        self._execute_leased_task(sp, reply_slot)
                elif kind == "actor_batch":
                    pusher = reply_slot
                    for sp in spec:
                        self._dispatch_actor_task(sp, pusher)
                elif spec.kind == ACTOR_TASK:
                    self._dispatch_actor_task(spec, None)
                else:
                    self._execute_task(spec)
                self._profiler_prep.poll()
            except BaseException as e:
                # A late cancel/timeout SIGINT (KeyboardInterrupt) escaping
                # the per-task guards must not fell the exec loop — the
                # worker keeps draining its queue; attribute what survived.
                print(f"exec loop survived {type(e).__name__} "
                      f"(task dispatch)", file=sys.stderr)
                traceback.print_exc()
        self.worker.disconnect()

    def _dispatch_actor_task(self, spec: TaskSpec, reply_slot):
        """Route an actor call to the right executor: async actors run
        coroutine methods on a dedicated asyncio loop bounded by a
        max_concurrency semaphore; threaded actors (max_concurrency>1) and
        methods in declared concurrency groups use per-group thread pools;
        default actors execute inline in arrival order (reference
        concurrency_group_manager.h + fiber.h for async actors)."""
        if spec.method_name == "__rt_dag_loop__":
            # Compiled-graph execution loop attached to this EXISTING actor
            # (reference compiled_dag_node: bound actors host channel
            # loops). Runs on its OWN thread so normal method calls keep
            # flowing; the reply resolves when the DAG tears down.
            self._start_dag_loop(spec, reply_slot)
            return
        if spec.method_name == "__rt_dag_cancel__":
            # Compiled-DAG teardown: cancel this actor's loop threads for
            # the named dag (their upstream may be dead, so the graceful
            # stop token may never arrive through the channels).
            error_blob = None
            try:
                (desc,), _ = self.worker.decode_args(spec.args, spec.kwargs)
                for ev in list(self._dag_stops.get(desc.get("tag"), ())):
                    ev.set()
            except BaseException as e:  # noqa: BLE001 - reply must go out
                error_blob = self._make_error_blob(spec, e)
            self._reply_value(reply_slot, spec.task_id,
                              self._finish_actor_task(spec, None, error_blob))
            return
        ent = self._method_cache.get(spec.method_name)
        if ent is None and self.actor_instance is not None:
            m = getattr(self.actor_instance, spec.method_name, None)
            group = getattr(m, "_rt_concurrency_group", None) if m is not None else None
            if group is not None and group not in self.actor_concurrency_groups:
                group = None  # undeclared group: fall back to default routing
            ent = self._method_cache[spec.method_name] = (
                m, m is not None and (inspect.iscoroutinefunction(m)
                                      or inspect.isasyncgenfunction(m)), group)
        group = ent[2] if ent is not None else None
        # Streaming item reports ride the caller's connection (the one the
        # reply pusher is bound to).
        conn = reply_slot.conn if reply_slot is not None else None
        if ent is not None and ent[1]:
            self._ensure_actor_loop()
            cf = asyncio.run_coroutine_threadsafe(
                self._a_exec_actor_task(spec, group, conn), self._actor_loop.loop)
            cf.add_done_callback(
                lambda f, rs=reply_slot, tid=spec.task_id: self._reply_future(rs, tid, f))
        elif group is not None:
            cf = self._group_pool(group).submit(
                self._execute_group_task, spec, group, conn)
            cf.add_done_callback(
                lambda f, rs=reply_slot, tid=spec.task_id: self._reply_future(rs, tid, f))
        elif self.actor_max_concurrency > 1:
            if self._actor_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._actor_pool = ThreadPoolExecutor(max_workers=self.actor_max_concurrency,
                                                      thread_name_prefix="rt-actor")
            cf = self._actor_pool.submit(self._execute_actor_task, spec, conn)
            cf.add_done_callback(
                lambda f, rs=reply_slot, tid=spec.task_id: self._reply_future(rs, tid, f))
        else:
            reply = self._execute_actor_task(spec, conn)
            self._reply_value(reply_slot, spec.task_id, reply)

    def _start_dag_loop(self, spec: TaskSpec, reply_slot):
        """Spawn the compiled-DAG stage loop thread for this actor."""
        def _run():
            error_blob = None
            value = None
            stop = threading.Event()
            tag = None
            try:
                from ray_tpu_torch.dag import run_stage_loop

                (desc,), _ = self.worker.decode_args(spec.args, spec.kwargs)
                tag = desc.get("tag")
                if tag:
                    self._dag_stops.setdefault(tag, []).append(stop)
                method = getattr(self.actor_instance, desc["method"])
                value = run_stage_loop(
                    method, desc["in_specs"], desc["out_names"],
                    desc.get("kwargs") or {}, desc["size"],
                    stage=desc.get("stage", "stage"), stop=stop)
            except BaseException as e:  # noqa: BLE001
                error_blob = self._make_error_blob(spec, e)
            finally:
                if tag:
                    evs = self._dag_stops.get(tag)
                    if evs is not None:
                        try:
                            evs.remove(stop)
                        except ValueError:
                            pass
                        if not evs:
                            self._dag_stops.pop(tag, None)
            reply = self._finish_actor_task(spec, value, error_blob)
            self._reply_value(reply_slot, spec.task_id, reply)

        threading.Thread(target=_run, daemon=True,
                         name="rt-dag-loop").start()

    def _group_pool(self, group: str):
        """Thread pool for one declared concurrency group (reference
        concurrency_group_manager.h: each group owns its executor, so a
        saturated group never blocks the others)."""
        pool = self._group_pools.get(group)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            limit = max(1, int(self.actor_concurrency_groups.get(group, 1)))
            pool = self._group_pools[group] = ThreadPoolExecutor(
                max_workers=limit, thread_name_prefix=f"rt-cg-{group}")
        return pool

    def _group_budget(self, group: str) -> threading.Semaphore:
        """ONE concurrency budget per group shared by the sync (thread
        pool) and async (actor loop) execution paths — a group mixing sync
        and async methods must still honor its declared limit."""
        sem = self._group_budgets.get(group)
        if sem is None:
            limit = max(1, int(self.actor_concurrency_groups.get(group, 1)))
            sem = self._group_budgets[group] = threading.Semaphore(limit)
        return sem

    def _execute_group_task(self, spec: TaskSpec, group: str, conn=None):
        sem = self._group_budget(group)
        sem.acquire()  # pool thread; blocking is fine
        try:
            return self._execute_actor_task(spec, conn)
        finally:
            sem.release()

    def _ensure_actor_loop(self):
        if self._actor_loop is None:
            self._actor_loop = rpc.EventLoopThread(name="rt-actor-loop")

            async def _mk_sem():
                return asyncio.Semaphore(max(1, self.actor_max_concurrency))

            self._actor_sem = self._actor_loop.run(_mk_sem())

    async def _a_acquire_group(self, group: str | None):
        """Acquire the shared group budget from the actor loop without
        blocking it (short poll; group methods are coarse-grained). None ->
        the whole-actor max_concurrency semaphore."""
        if group is None:
            await self._actor_sem.acquire()
            return self._actor_sem.release
        sem = self._group_budget(group)
        while not sem.acquire(blocking=False):
            await asyncio.sleep(0.002)
        return sem.release

    async def _a_exec_actor_task(self, spec: TaskSpec, group: str | None = None,
                                 conn=None) -> dict:
        release = await self._a_acquire_group(group)
        try:
            return await self._a_exec_actor_task_inner(spec, conn)
        finally:
            release()

    async def _a_exec_actor_task_inner(self, spec: TaskSpec, conn=None) -> dict:
        error_blob = None
        value = None
        streaming = spec.num_returns == STREAMING
        gen_count = 0
        # Execute span + context for async actor methods: set inside this
        # coroutine, the contextvar scopes to it — everything the method
        # does (engine submits, nested calls, streamed iteration) chains
        # under the execute span without leaking to sibling requests.
        trace_h = _tracing.task_execute_begin(spec)
        t0 = time.time()
        try:
            method = getattr(self.actor_instance, spec.method_name)
            args, kwargs = self.worker.decode_args(spec.args, spec.kwargs)
            r = method(*args, **kwargs)
            if hasattr(r, "__anext__"):
                if not streaming:
                    raise TypeError(
                        f"async generator method {spec.method_name!r} "
                        f"requires num_returns='streaming'")
                value = r
            else:
                value = await r
            if streaming:
                gen_count, gerr, _ = await self._a_stream_generator(
                    spec, value, conn)
                if gerr is not None:
                    error_blob = gerr
        except BaseException as e:  # noqa: BLE001
            error_blob = self._make_error_blob(spec, e)
        _tracing.task_execute_end(trace_h, ok=error_blob is None)
        self._record_event(spec, t0, time.time(), error_blob is None)
        if streaming:
            return {"results": self._package_stream_completion(
                spec, gen_count, error_blob), "error": error_blob}
        return self._finish_actor_task(spec, value, error_blob)

    def _reply_value(self, pusher, task_id: str, reply: dict):
        if pusher is not None:  # None once the holder's connection closed
            # Compact wire record (see _done_item): dict replies with five
            # constant keys cost ~2x the pickle of a tuple at n:n rates.
            pusher.add((task_id, 0, reply.get("results"), reply.get("error"),  # rtcheck: wire=tasks_done.item
                        False, reply.get("exec_failure")))

    def _reply_future(self, pusher, task_id: str, done_future):
        try:
            reply = done_future.result()
        except BaseException as e:  # executor infrastructure failure
            reply = {"results": [], "error": None, "exec_failure": str(e)}
        self._reply_value(pusher, task_id, reply)

    _EVENT_RATE_FULL = 500  # events/s below which everything records
    _EVENT_SAMPLE = 64      # 1/N sampling above the rate threshold

    def _record_event(self, spec: TaskSpec, start: float, end: float,
                      ok: bool):
        """Buffer one execution event (batched to the controller; feeds
        ray_tpu_torch.timeline() and the state list APIs). ADAPTIVE shedding:
        everything records at ordinary rates (full timelines), but past
        _EVENT_RATE_FULL successful events/s this worker samples 1/N —
        at tens of thousands of calls/s the per-event dict + push costs a
        measurable third of the core budget (observed n:n actor bench
        14.5k -> 22.5k/s; the reference task_event_buffer likewise sheds
        load under pressure). Failures always record."""
        if ok:
            now = end
            if now - self._event_win_start >= 1.0:
                self._event_win_start = now
                self._event_win_count = 0
            self._event_win_count += 1
            if self._event_win_count > self._EVENT_RATE_FULL:
                self._event_seq += 1
                if self._event_seq % self._EVENT_SAMPLE:
                    return
        try:
            self._event_pusher.add({
                "task_id": spec.task_id, "name": spec.name,
                "kind": spec.kind, "attempt": spec.attempt,
                "start": start, "end": end, "ok": ok,
                "worker_id": self.worker_id, "node_id": self.node_id,
                "pid": self._pid,
            })
        except Exception:
            pass  # observability must never break execution

    # ------------------------------------------------ streaming generators
    def _on_gen_ack(self, task_id: str, consumed: int):
        with self._gen_cond:
            # Only update LIVE streams (registered by the stream loop): a
            # late ack landing after the stream's finally-pop must not
            # re-create the entry — long-lived workers would leak one dict
            # slot per streaming task served.
            if task_id in self._gen_acks and consumed > self._gen_acks[task_id]:
                self._gen_acks[task_id] = consumed
                self._gen_cond.notify_all()

    def _on_gen_close(self, task_id: str):
        """Owner dropped its ObjectRefGenerator: stop producing. This is the
        only stop path for actor-task streams (no lease/controller cancel
        reaches them) and it also unblocks a parked backpressure wait.
        Only LIVE streams are marked (same guard as _on_gen_ack): a close
        landing after the stream's finally would leak a set entry per
        abandoned stream in a long-lived worker. A close that beats the
        stream's start is re-sent by the owner on every later straggler
        item, so the live stream still learns of it."""
        with self._gen_cond:
            if task_id in self._gen_acks:
                self._gen_closed.add(task_id)
                self._gen_cond.notify_all()

    def _gen_pusher_for(self, conn) -> "_BatchPusher | None":
        pusher = self._gen_pushers.get(conn)
        if pusher is None and conn is not None and not conn.closed:
            pusher = self._gen_pushers[conn] = _BatchPusher(
                conn, "gen_items", "items")
            if conn.closed:
                # Raced with the close between the check and the insert (the
                # on_close prune may already have run and found nothing):
                # prune our own insert — same pattern as _pusher_for.
                self._gen_pushers.pop(conn, None)
        return pusher

    def _serialize_return(self, oid: str, value) -> tuple:
        """Serialize ONE return value into its wire/result tuple
        (oid, inline, size, holder): small inline, large into the node shm
        store with the agent as the advertised holder (it outlives workers).
        Shared by regular returns and streamed generator items so the inline
        threshold / detach / escaping-ref rules can never diverge."""
        if device_store.eligible(value):
            # Device object plane: pin the live array here instead of
            # copying it through the host store; the placeholder rides the
            # reply/advertise as the inline payload with this worker's
            # address as the device-location hint (README "Device objects").
            return device_store.pin_return(oid, value, self.worker)
        sobj = serialize(value, ref_class=ObjectRef)
        if sobj.contained_refs:
            # Returned refs escape to the caller here: refs THIS worker owns
            # (results of its own sub-calls) must reach the controller
            # before the borrower can possibly wait on them.
            self.worker._advertise_escaping(
                [r.hex() if isinstance(r, ObjectRef) else r
                 for r in sobj.contained_refs])
        size = sobj.total_bytes()
        if size <= CONFIG.max_inline_object_bytes:
            return (oid, [sobj.to_bytes()], size, None)
        self.worker.store.put_serialized(oid, sobj)
        # Drop the producer's mapping: the agent is the advertised holder,
        # and keeping it would pin freed pages until this worker exits
        # (same-host readers re-attach from the file).
        self.worker.store.detach(oid)
        return (oid, None, size, self.agent_addr)

    def _advert_item(self, oid: str, size, inline, holder, owner,
                     error) -> dict:
        """One register_put advertise record; device-plane results (pinned
        by _serialize_return) carry the plane marker so the controller can
        route frees and the producer-death lost sweep."""
        item = {"oid": oid, "size": size, "inline": inline,
                "holder": holder, "owner": owner, "error": error}
        if device_store.holds(oid):
            item.update(device_store.advert_fields(self.worker_id,
                                                   self.node_id))
        return item

    def _package_one(self, spec: TaskSpec, idx: int, value) -> tuple:
        """Package ONE yielded stream item, advertising shm items to the
        controller immediately so third-party borrowers can fetch."""
        oid = spec.task_id + idx.to_bytes(4, "little").hex()
        watchdog.report_progress()  # each yielded item IS progress
        result = self._serialize_return(oid, value)
        if result[3] is not None:
            # result[1] is None for host shm items and the placeholder for
            # device items — same shape as the non-streaming advertises.
            self._advertise_pusher.add(self._advert_item(
                oid, result[2], result[1], result[3], spec.owner_id, None))
        return result

    def _stream_generator(self, spec: TaskSpec, value, conn):
        """Drive a sync generator/iterable, reporting each item to the owner
        as it is yielded (reference ReportGeneratorItemReturns,
        core_worker.proto:478). Returns (count, error_blob, exception).
        Backpressure: pause once `generator_backpressure_items` items are
        unacknowledged (acks ride `gen_ack` pushes from the consumer)."""
        pusher = self._gen_pusher_for(conn)
        thresh = CONFIG.generator_backpressure_items
        tid = spec.task_id
        # iter() BEFORE registering as live: a non-iterable return raises
        # here, and registering first would leak the _gen_acks entry (the
        # finally below would never run).
        it = iter(value)
        with self._gen_cond:
            self._gen_acks[tid] = 0  # register as live (acks update only live streams)
        idx = 0
        try:
            for item in it:
                with self._gen_cond:
                    if tid in self._gen_closed:
                        break  # consumer abandoned the stream
                result = self._package_one(spec, idx, item)
                if pusher is not None:
                    pusher.add((tid, idx, result))
                idx += 1
                if thresh > 0 and idx % thresh == 0:
                    with self._gen_cond:
                        while (idx - self._gen_acks.get(tid, 0) >= thresh
                               and tid not in self._gen_closed
                               and conn is not None and not conn.closed):
                            self._gen_cond.wait(timeout=0.25)
            return idx, None, None
        except BaseException as e:  # noqa: BLE001 — user generator code
            return idx, self._make_error_blob(spec, e), e
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()  # run the generator's finally blocks
                except Exception:
                    pass
            with self._gen_cond:
                self._gen_acks.pop(tid, None)
                self._gen_closed.discard(tid)

    async def _a_stream_generator(self, spec: TaskSpec, value, conn):
        """Async flavor for async-generator actor methods (runs on the actor
        loop — backpressure waits must not block the loop)."""
        pusher = self._gen_pusher_for(conn)
        thresh = CONFIG.generator_backpressure_items
        tid = spec.task_id
        # iter() BEFORE registering as live (see _stream_generator).
        if not hasattr(value, "__anext__"):
            value = iter(value)
        with self._gen_cond:
            self._gen_acks[tid] = 0  # register as live
        idx = 0
        try:
            while True:
                if tid in self._gen_closed:
                    break  # consumer abandoned the stream
                try:
                    if hasattr(value, "__anext__"):
                        item = await value.__anext__()
                    else:
                        item = next(value)
                except (StopAsyncIteration, StopIteration):
                    break
                result = self._package_one(spec, idx, item)
                if pusher is not None:
                    pusher.add((tid, idx, result))
                idx += 1
                if thresh > 0 and idx % thresh == 0:
                    while (idx - self._gen_acks.get(tid, 0) >= thresh
                           and tid not in self._gen_closed
                           and conn is not None and not conn.closed):
                        await asyncio.sleep(0.005)
            return idx, None, None
        except BaseException as e:  # noqa: BLE001
            return idx, self._make_error_blob(spec, e), e
        finally:
            aclose = getattr(value, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass
            with self._gen_cond:
                self._gen_acks.pop(tid, None)
                self._gen_closed.discard(tid)

    def _package_stream_completion(self, spec: TaskSpec, count: int,
                                   error_blob) -> list:
        """The streaming task's single declared return: the completion
        sentinel, resolving to the item count (or carrying the error)."""
        comp_oid = spec.return_object_ids()[0]
        if error_blob is not None:
            return [(comp_oid, None, 0, None)]
        sobj = serialize(count, ref_class=ObjectRef)
        return [(comp_oid, [sobj.to_bytes()], sobj.total_bytes(), None)]

    # ---------------------------------------------------------- execution
    def _package_results(self, spec: TaskSpec, value, error_blob):
        """Serialize return values: small inline, large into the node shm
        store with the agent as the advertised holder (it outlives workers)."""
        results = []
        oids = spec.return_object_ids()
        if error_blob is not None:
            for oid in oids:
                results.append((oid, None, 0, None))
            return results
        if spec.num_returns == 0:
            return results
        values = [value] if spec.num_returns == 1 else list(value)
        if spec.num_returns > 1 and len(values) != spec.num_returns:
            raise ValueError(
                f"task {spec.name} declared num_returns={spec.num_returns} "
                f"but returned {len(values)} values"
            )
        for oid, v in zip(oids, values):
            results.append(self._serialize_return(oid, v))
        return results

    def _make_error_blob(self, spec: TaskSpec, e: BaseException):
        if isinstance(e, KeyboardInterrupt):
            h, bufs = dumps_oob({"type": "TaskCancelledError",
                                 "message": f"task {spec.name} cancelled"})
            return [h, *bufs]
        tb = traceback.format_exc()
        cause_header = None
        try:
            cause_header, cause_bufs = dumps_oob(e)
            if cause_bufs:
                cause_header = None  # keep error blobs simple: no oob bufs
        except Exception:
            cause_header = None
        h, bufs = dumps_oob(
            {
                "type": "TaskError",
                "function_name": spec.name,
                "traceback": tb,
                "cause": cause_header,
            }
        )
        return [h, *bufs]

    @staticmethod
    def _exception_retryable(spec: TaskSpec, e: BaseException) -> bool:
        """retry_exceptions semantics (reference remote_function.py options):
        True -> any Exception retries; a list/tuple of types -> isinstance
        match; False/None -> user exceptions are final."""
        if isinstance(e, KeyboardInterrupt):
            return False  # cancellation is never retried
        rx = spec.retry_exceptions
        if rx is True:
            return isinstance(e, Exception)
        if isinstance(rx, (list, tuple)):
            return any(isinstance(e, t) for t in rx if isinstance(t, type))
        return False

    def _execute_task(self, spec: TaskSpec):
        """Outer shell: a cancel SIGINT can land in any crack of the inner
        body (e.g. the env-restore finally) — whatever happens, a task_done
        MUST reach the controller or the caller blocks and the agent counts
        the slot busy forever."""
        try:
            self._execute_task_inner(spec)
            return
        except KeyboardInterrupt:
            error_blob = self._make_error_blob(spec, KeyboardInterrupt())
        results = self._package_results(spec, None, error_blob)

        async def _report():
            await self.worker.controller.push(
                "task_done", task_id=spec.task_id, attempt=spec.attempt,
                results=results, error=error_blob, retryable=False, spec=None)
            if spec.kind == NORMAL:
                await self.agent_conn.push("worker_idle", worker_id=self.worker_id)

        for _ in range(2):
            try:
                self.worker.io.run(_report())
                break
            except KeyboardInterrupt:
                continue

    def _execute_task_inner(self, spec: TaskSpec):
        error_blob = None
        value = None
        retryable = False
        # Apply per-task env vars; restore after on pooled (non-actor)
        # workers so a reused worker doesn't leak the previous task's env
        # (reference keys the worker pool by runtime env, worker_pool.h:228).
        saved_env: dict[str, str | None] = {}
        env_vars = spec.runtime_env.get("env_vars") or {}
        for k, v in env_vars.items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        undo_env = lambda: None  # noqa: E731
        self._current_task_id = spec.task_id
        self._current_attempt = spec.attempt
        trace_h = _tracing.task_execute_begin(spec)
        watchdog.task_begin(spec.task_id, spec.name, spec.attempt, spec.kind,
                            trace_id=spec.trace[0] if spec.trace else None)
        timer = self._arm_task_timeout(spec)
        t0 = time.time()
        try:
            # Inside the try: a bad package (missing KV blob, corrupt zip)
            # must surface as a task error, not crash the worker loop.
            undo_env = _rtenv.apply(self.worker, spec.runtime_env)
            if spec.task_id in self._cancel_requested:
                self._cancel_requested.discard(spec.task_id)
                raise KeyboardInterrupt  # cancelled before it started
            if spec.kind == ACTOR_CREATE:
                cls = self.worker.load_function(spec.function_id)
                args, kwargs = self.worker.decode_args(spec.args, spec.kwargs)
                self.actor_instance = cls(*args, **kwargs)
                self._method_cache.clear()
                self.actor_id = spec.actor_id
                self.actor_max_concurrency = max(1, spec.max_concurrency)
                self.actor_concurrency_groups = dict(spec.concurrency_groups or {})
            else:
                if spec.num_returns == STREAMING:
                    raise RuntimeError(
                        "streaming generators are not supported on the "
                        "controller dispatch path (TPU tasks / "
                        "reconstruction); use the lease path or an actor")
                fn = self.worker.load_function(spec.function_id)
                args, kwargs = self.worker.decode_args(spec.args, spec.kwargs)
                value = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — user code may raise anything
            timed_out = self._consume_timeout(spec, e)
            if timed_out is not None:
                error_blob, retryable = timed_out
            else:
                error_blob = self._make_error_blob(spec, e)
                retryable = self._exception_retryable(spec, e)
            if spec.kind == ACTOR_CREATE:
                logger.error("actor __init__ failed:\n%s", traceback.format_exc())
        finally:
            if timer is not None:
                timer.cancel()
            self._timed_out.discard((spec.task_id, spec.attempt))
            self._current_task_id = None
            watchdog.task_end(error_blob is None)
            _tracing.task_execute_end(trace_h, ok=error_blob is None)
            self._record_event(spec, t0, time.time(), error_blob is None)
            if spec.kind != ACTOR_CREATE:  # dedicated actor procs keep their env
                undo_env()
                for k, old in saved_env.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
        try:
            results = self._package_results(spec, value, error_blob)
        except KeyboardInterrupt:
            # Late cancel signal after user code finished: the result stands.
            results = self._package_results(spec, value, error_blob)
        except BaseException as e:
            error_blob = self._make_error_blob(spec, e)
            results = self._package_results(spec, None, error_blob)

        async def _report():
            payload = dict(task_id=spec.task_id, attempt=spec.attempt,
                           results=results, error=error_blob,
                           retryable=retryable, spec=None)
            if spec.kind == ACTOR_CREATE:
                payload["actor_address"] = self.worker.server_addr
            await self.worker.controller.push("task_done", **payload)
            if spec.kind == NORMAL:
                await self.agent_conn.push("worker_idle", worker_id=self.worker_id)

        for _ in range(2):  # a late cancel SIGINT must not lose the report
            try:
                self.worker.io.run(_report())
                break
            except KeyboardInterrupt:
                continue

    def _execute_leased_task(self, spec: TaskSpec, conn):
        """Direct-path execution: results go straight back to the lease
        holder over the connection the spec arrived on (batched), and are
        advertised to the controller's object directory in batched frames
        for third-party borrowers. No per-task agent involvement — the slot
        stays leased (reference: executing a PushNormalTask on a leased
        worker, task_receiver.h:51)."""
        with self._ltask_lock:
            if spec.task_id in self._skip_ltasks:
                # The holder's connection died before this spec started:
                # the owner fails it over to the controller path, so running
                # it here too would double-execute.
                self._skip_ltasks.discard(spec.task_id)
                return
            self._pending_ltasks.pop(spec.task_id, None)
            self._current_ltask = (spec.task_id, spec.attempt, conn)
        try:
            self._execute_leased_task_inner(spec, conn)
        except KeyboardInterrupt:
            # A cancel/timeout SIGINT can land in any crack the inner
            # body's own retry loops don't cover (e.g. the env-restore
            # finally, right as the task completed): the reply may never
            # have been delivered, and a lost reply hangs the owner's
            # get() forever. Send a best-effort outcome — if the real
            # reply already went out, the owner ignores this duplicate
            # (its inflight entry is gone).
            timed_out = (spec.task_id, spec.attempt) in self._timed_out
            self._timed_out.discard((spec.task_id, spec.attempt))
            if timed_out:
                h, bufs = dumps_oob({
                    "type": "TaskTimeoutError",
                    "message": f"task {spec.name} (attempt {spec.attempt}) "
                               f"exceeded its per-attempt timeout of "
                               f"{spec.timeout_s}s"})
                retryable = True
            else:
                h, bufs = dumps_oob({
                    "type": "TaskCancelledError",
                    "message": f"task {spec.name} cancelled"})
                retryable = False
            pusher = self._pusher_for(conn)
            if pusher is not None:
                pusher.add((spec.task_id, spec.attempt,  # rtcheck: wire=tasks_done.item
                            [(oid, None, 0, None)
                             for oid in spec.return_object_ids()],
                            [h, *bufs], retryable, None))
        finally:
            with self._ltask_lock:
                self._current_ltask = None

    def _report_orphaned(self, payloads):
        """Holder gone with these outcomes possibly undelivered: publish
        them to the node agent's dedup table (`ltask_done`) so the owner's
        failover re-dispatch resolves from the record instead of executing
        the task a second time."""
        if self.agent_conn is None:
            return
        for tid, attempt, results, error, retryable, _ in payloads:
            try:
                self.agent_conn.push_threadsafe(
                    "ltask_done", worker_id=self.worker_id, task_id=tid,
                    attempt=attempt, results=results, error=error,
                    retryable=retryable)
            except Exception:
                return

    def _execute_leased_task_inner(self, spec: TaskSpec, conn):
        error_blob = None
        value = None
        retryable = False
        streaming = spec.num_returns == STREAMING
        gen_count = 0
        saved_env: dict[str, str | None] = {}
        env_vars = spec.runtime_env.get("env_vars") or {}
        for k, v in env_vars.items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        undo_env = lambda: None  # noqa: E731
        self._current_task_id = spec.task_id
        self._current_attempt = spec.attempt
        trace_h = _tracing.task_execute_begin(spec)
        watchdog.task_begin(spec.task_id, spec.name, spec.attempt, spec.kind,
                            trace_id=spec.trace[0] if spec.trace else None)
        timer = self._arm_task_timeout(spec)
        t0 = time.time()
        try:
            undo_env = _rtenv.apply(self.worker, spec.runtime_env)
            if spec.task_id in self._cancel_requested:
                self._cancel_requested.discard(spec.task_id)
                raise KeyboardInterrupt  # cancelled before it started
            fn = self.worker.load_function(spec.function_id)
            args, kwargs = self.worker.decode_args(spec.args, spec.kwargs)
            value = fn(*args, **kwargs)
            if streaming:
                # Stream items while still "executing" (cancel interrupts
                # the iteration via the same SIGINT path).
                gen_count, gerr, gexc = self._stream_generator(
                    spec, value, conn)
                if gerr is not None:
                    error_blob = gerr
                    retryable = self._exception_retryable(spec, gexc)
        except BaseException as e:  # noqa: BLE001 — user code may raise anything
            timed_out = self._consume_timeout(spec, e)
            if timed_out is not None:
                error_blob, retryable = timed_out
            else:
                error_blob = self._make_error_blob(spec, e)
                retryable = self._exception_retryable(spec, e)
        finally:
            if timer is not None:
                timer.cancel()
            self._timed_out.discard((spec.task_id, spec.attempt))
            self._current_task_id = None
            watchdog.task_end(error_blob is None)
            _tracing.task_execute_end(trace_h, ok=error_blob is None)
            self._record_event(spec, t0, time.time(), error_blob is None)
            undo_env()
            for k, old in saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
        try:
            results = (self._package_stream_completion(spec, gen_count, error_blob)
                       if streaming
                       else self._package_results(spec, value, error_blob))
        except KeyboardInterrupt:
            results = (self._package_stream_completion(spec, gen_count, error_blob)
                       if streaming
                       else self._package_results(spec, value, error_blob))
        except BaseException as e:
            error_blob = self._make_error_blob(spec, e)
            results = self._package_results(spec, None, error_blob)

        pusher = self._pusher_for(conn)
        # Compact `tasks_done` item (parsed by lease._task_done /
        # _ActorPipe._on_push): (task_id, attempt, results, error,
        # retryable, exec_failure).
        payload = (spec.task_id, spec.attempt, results, error_blob,  # rtcheck: wire=tasks_done.item
                   retryable, None)
        # Don't advertise transient (to-be-retried) errors: the owner will
        # resubmit, and a poisoned directory entry would outlive the retry.
        # Inline results aren't advertised at all: the owner resolves from
        # the direct reply, and a third-party borrower is served on demand
        # via the controller's need_object pull to the owner (reference:
        # owned inline objects live with the owner, not in the GCS).
        will_retry = (error_blob is not None and retryable
                      and spec.attempt < spec.max_retries)
        if not will_retry:
            for oid, inline, size, holder in results:
                if holder is not None:
                    self._advertise_pusher.add(self._advert_item(
                        oid, size, inline, holder, spec.owner_id,
                        error_blob))
        delivered = False
        for _ in range(2):  # a late cancel SIGINT must not lose the report
            try:
                if pusher is not None:
                    pusher.add(payload)
                    delivered = True
                break
            except KeyboardInterrupt:
                continue
        if will_retry or streaming:
            # The owner's requeue owns a retried outcome, and streaming
            # specs never ride the controller failover path (it has no item
            # transport): no dedup record for either.
            return
        # At-most-once across owner failover: make the final outcome
        # durable at the NODE. Holder already gone -> the owner can only
        # learn it through the failover re-dispatch, whose agent-side dedup
        # replays the record. Holder still connected -> park the payload
        # per connection; the prune republishes it only if the connection
        # dies with the reply possibly unflushed.
        import collections

        orphaned = None
        with self._ltask_lock:
            if delivered and not conn.closed:
                rq = self._recent_ltasks.get(conn)
                if rq is None:
                    rq = self._recent_ltasks[conn] = collections.deque(
                        maxlen=64)
                rq.append(payload)
            else:
                orphaned = [payload]
        if orphaned:
            self._report_orphaned(orphaned)

    def _execute_actor_task(self, spec: TaskSpec, conn=None) -> dict:
        error_blob = None
        value = None
        streaming = spec.num_returns == STREAMING
        gen_count = 0
        # Progress beacon for sync actor methods (threaded/default paths;
        # async methods ride the actor loop and are not thread-attributable).
        trace_h = _tracing.task_execute_begin(spec)
        watchdog.task_begin(spec.task_id, spec.name, spec.attempt,
                            spec.kind,
                            trace_id=spec.trace[0] if spec.trace else None)
        t0 = time.time()
        try:
            if self.actor_instance is None:
                raise RuntimeError("actor instance not initialized")
            ent = self._method_cache.get(spec.method_name)
            method = ent[0] if ent is not None and ent[0] is not None \
                else getattr(self.actor_instance, spec.method_name)
            if spec.args or spec.kwargs:
                args, kwargs = self.worker.decode_args(spec.args, spec.kwargs)
                value = method(*args, **kwargs)
            else:
                value = method()
            if streaming:
                gen_count, gerr, _ = self._stream_generator(spec, value, conn)
                if gerr is not None:
                    error_blob = gerr
        except BaseException as e:  # noqa: BLE001
            error_blob = self._make_error_blob(spec, e)
        watchdog.task_end(error_blob is None)
        _tracing.task_execute_end(trace_h, ok=error_blob is None)
        self._record_event(spec, t0, time.time(), error_blob is None)
        if streaming:
            return {"results": self._package_stream_completion(
                spec, gen_count, error_blob), "error": error_blob}
        return self._finish_actor_task(spec, value, error_blob)

    def _finish_actor_task(self, spec: TaskSpec, value, error_blob) -> dict:
        try:
            results = self._package_results(spec, value, error_blob)
        except BaseException as e:
            error_blob = self._make_error_blob(spec, e)
            results = self._package_results(spec, None, error_blob)

        # Advertise shm results to the controller (batched one-way frames)
        # so refs passed to third parties resolve; inline results live with
        # the owner (who gets them in the reply) and are served to borrowers
        # via the controller's need_object pull.
        for oid, inline, size, holder in results:
            if holder is not None:
                self._advertise_pusher.add(self._advert_item(
                    oid, size, inline, holder, spec.owner_id, error_blob))
        return {"results": results, "error": error_blob}


def _install_stack_dump():
    """SIGUSR1 -> dump all thread stacks to a per-pid file (the reporter
    role the reference fills with py-spy via the dashboard agent,
    dashboard/modules/reporter/). Read back by the node agent for the
    dashboard's /api/stacks endpoint.

    faulthandler.register installs a C-LEVEL handler on a pre-opened fd:
    it dumps even when the worker is hung inside native code holding the
    GIL — exactly the case an operator reaches for stacks. Dumps APPEND;
    the agent reads from its recorded offset once the file stops growing."""
    import faulthandler
    import signal

    from ray_tpu_torch._private.rtconfig import stack_dump_path

    path = stack_dump_path(os.environ.get("RT_SESSION", ""), os.getpid())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        f = open(path, "a")
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
    except Exception:
        # Registration failed (unwritable dir, ENOSPC): install a NO-OP
        # handler anyway — SIGUSR1's default disposition TERMINATES the
        # process, so a later /api/stacks probe must not kill a healthy
        # worker just because its dump file couldn't be opened.
        try:
            signal.signal(signal.SIGUSR1, lambda s_, f_: None)
        except Exception:
            pass


def main():
    import signal

    _prof = [None]

    def _term(signum, frame):
        if _prof[0] is not None:
            try:
                _prof[0].disable()
                _prof[0].dump_stats(os.path.join(
                    CONFIG.profile_worker, f"worker_{os.getpid()}.pstats"))
            except Exception:
                pass
        rpc.cleanup_sockets()
        os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    _install_stack_dump()
    logging.basicConfig(level=logging.INFO, format=f"[worker %(process)d] %(message)s")
    proc = WorkerProc()
    proc.start()
    profile_dir = CONFIG.profile_worker
    if profile_dir:  # dev-only: per-worker cProfile dumps for hot-path work
        import cProfile

        pr = cProfile.Profile()
        _prof[0] = pr
        pr.enable()
        try:
            proc.run()
        except KeyboardInterrupt:
            pass
        finally:
            pr.disable()
            pr.dump_stats(os.path.join(profile_dir, f"worker_{os.getpid()}.pstats"))
        return
    try:
        proc.run()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

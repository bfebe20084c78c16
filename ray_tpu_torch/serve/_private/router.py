"""Client-side router: replica membership via long-poll, power-of-two
choices balancing, and DeploymentHandle.

Parity target: reference python/ray/serve/_private/router.py:321 (Router —
per-handle replica scheduling) + replica_scheduler/pow_2_scheduler.py:52
(sample two replicas, pick the lower outstanding count) + handle.py
(DeploymentHandle/DeploymentResponse).

Counterpart: ray_tpu/serve/_private/router.py (copied).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.exceptions import BackPressureError

logger = logging.getLogger(__name__)


class QueueCancelled(Exception):
    """The client abandoned a request while it was still QUEUED (never
    assigned): the proxy sets the request's cancel event on disconnect and
    the admission loop exits here — the queue slot frees immediately
    instead of riding out the deadline for nobody."""


def _retry_pause_s(attempt: int) -> float:
    """Jittered exponential backoff between replica-death re-assignments:
    full jitter (0.5x-1.5x) so a killed replica's whole backlog does not
    re-dispatch against the survivors in one synchronized wave."""
    base = max(0.001, float(CONFIG.serve_retry_base_s))
    return min(1.0, base * (2 ** attempt)) * (0.5 + random.random())


def _is_replica_busy(e: BaseException) -> bool:
    """A replica-side concurrency-cap rejection — raised in the replica so
    it crosses the wire wrapped in TaskError with the typed cause."""
    from ray_tpu_torch.exceptions import TaskError

    if isinstance(e, BackPressureError):
        return e.reason == "replica_busy"
    return (isinstance(e, TaskError)
            and isinstance(getattr(e, "cause", None), BackPressureError)
            and e.cause.reason == "replica_busy")

_routers: dict[str, "Router"] = {}
_routers_lock = threading.Lock()


class AsyncResolver:
    """Bridges ObjectRef completion to asyncio futures with ONE background
    thread per event loop, so awaiting a response never parks a thread for
    the request duration (used by the HTTP proxy and by awaited
    DeploymentResponses inside async deployments)."""

    def __init__(self, loop):
        import asyncio  # noqa: F401 (loop comes from the caller)

        self._loop = loop
        self._pending: dict = {}  # ref -> asyncio future
        self._lock = threading.Lock()
        self._wake = threading.Event()
        threading.Thread(target=self._run, daemon=True,
                         name="serve-resolver").start()

    def submit(self, ref):
        fut = self._loop.create_future()
        with self._lock:
            self._pending[ref] = fut
        self._wake.set()
        return fut

    def _run(self):
        while True:
            if self._loop.is_closed():
                # Loop gone (serve torn down in this process): stop polling
                # and drop the registry entry so loop + thread can be GC'd.
                with _resolvers_lock:
                    if _loop_resolvers.get(id(self._loop)) is self:
                        _loop_resolvers.pop(id(self._loop), None)
                return
            with self._lock:
                refs = list(self._pending)
            if not refs:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.1)
            except Exception:
                time.sleep(0.05)
                continue
            for ref in done:
                with self._lock:
                    fut = self._pending.pop(ref, None)
                if fut is None:
                    continue
                try:
                    val = ray_tpu_torch.get(ref, timeout=10)
                    err = None
                except Exception as e:  # noqa: BLE001
                    val, err = None, e
                try:
                    self._loop.call_soon_threadsafe(_resolve_fut, fut, val, err)
                except RuntimeError:
                    pass  # loop closed under us


def _resolve_fut(fut, val, err):
    if fut.done():
        return
    if err is not None:
        fut.set_exception(err)
    else:
        fut.set_result(val)


_loop_resolvers: dict = {}
_resolvers_lock = threading.Lock()


def resolver_for(loop) -> AsyncResolver:
    with _resolvers_lock:
        r = _loop_resolvers.get(id(loop))
        if r is None:
            r = _loop_resolvers[id(loop)] = AsyncResolver(loop)
        return r


def get_router(controller_name: str, deployment: str) -> "Router":
    key = f"{controller_name}/{deployment}"
    with _routers_lock:
        r = _routers.get(key)
        if r is None or r.dead:
            r = _routers[key] = Router(controller_name, deployment)
        return r


def reset_routers():
    with _routers_lock:
        for r in _routers.values():
            r.close()
        _routers.clear()


class Router:
    def __init__(self, controller_name: str, deployment: str):
        self.controller_name = controller_name
        self.deployment = deployment
        self.dead = False
        self._replicas: list[tuple[str, Any]] = []
        self._version = -1
        self._have_replicas = threading.Event()
        self._outstanding: dict[str, int] = {}
        self._tracked: dict = {}  # result ref -> replica id
        # model id -> replica ids this router sent that model to (cache
        # locality for multiplexed deployments; router-local knowledge —
        # a wrong guess only costs the replica a model reload).
        self._model_replicas: dict[str, list] = {}
        # Reentrant: shed accounting (record_shed) runs under the queue
        # condition, which shares this lock.
        self._lock = threading.RLock()
        # Admission plane (README "Overload & admission control"): budgets
        # arrive on the routing long-poll frame when RT_SERVE_ADMISSION is
        # on (None keeps the legacy uncapped path). The condition shares
        # the router lock; the drain loop notifies as slots free and the
        # long-poll notifies on membership changes, so queued requests
        # wake exactly when assignment might newly succeed.
        self._budgets: Optional[dict] = None
        self._slots = threading.Condition(self._lock)
        self._queued = 0
        self._shed_total = 0
        self._shed_counts: dict[str, int] = {}
        self._last_shed_t = 0.0  # last shed (overload-transition detector)
        self._last_shed_event_t = 0.0  # last serve_shed event (throttle)
        self._closed = threading.Event()
        threading.Thread(target=self._longpoll_loop, daemon=True,
                         name=f"serve-router-{deployment}").start()
        threading.Thread(target=self._drain_loop, daemon=True,
                         name=f"serve-drain-{deployment}").start()

    # ------------------------------------------------------------ membership
    def _longpoll_loop(self):
        while not self._closed.is_set():
            try:
                controller = ray_tpu_torch.get_actor(self.controller_name)
                rep = ray_tpu_torch.get(
                    controller.get_routing.remote(
                        self.deployment, self._version, 10.0), timeout=15)
                with self._lock:
                    self._version = rep["version"]
                    self._replicas = list(rep["replicas"])
                    self._budgets = rep.get("budgets")
                    live = {rid for rid, _h in self._replicas}
                    self._outstanding = {
                        rid: n for rid, n in self._outstanding.items()
                        if rid in live}
                    self._model_replicas = {
                        m: [r for r in rids if r in live]
                        for m, rids in self._model_replicas.items()}
                    # Fresh replicas may have free slots for queued work.
                    self._slots.notify_all()
                if self._replicas:
                    self._have_replicas.set()
                else:
                    self._have_replicas.clear()
            except Exception as e:
                if self._closed.is_set():
                    return
                logger.debug("serve router long-poll error: %r", e)
                time.sleep(0.2)

    def _drain_loop(self):
        """Decrement outstanding counts as responses resolve — the
        client-side queue-length signal pow-2 balancing reads (reference
        RouterMetricsManager.dec_num_running_requests_for_replica)."""
        while not self._closed.is_set():
            with self._lock:
                refs = list(self._tracked)
            if not refs:
                time.sleep(0.005)
                continue
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.2)
            except Exception:
                time.sleep(0.05)
                continue
            if done:
                with self._lock:
                    for ref in done:
                        rid = self._tracked.pop(ref, None)
                        if rid is not None and rid in self._outstanding:
                            self._outstanding[rid] = max(
                                0, self._outstanding[rid] - 1)
                    # A finished request is a freed slot: wake the queue.
                    self._slots.notify_all()

    # ----------------------------------------------------------- admission
    def record_shed(self, reason: str, n: int = 1):
        """Account one shed: stats counter, metrics, and a THROTTLED event
        (sheds arrive at offered-load rate under overload — one aggregate
        serve_shed event per window, plus a serve_overload marker on the
        transition into saturation after a quiet period)."""
        from ray_tpu_torch._private.events import emit_event
        from ray_tpu_torch.util import metrics

        now = time.monotonic()
        with self._lock:
            self._shed_total += n
            self._shed_counts[reason] = self._shed_counts.get(reason, 0) + n
            quiet = now - self._last_shed_t > 5.0
            self._last_shed_t = now
            flush = now - self._last_shed_event_t > 2.0
            counts = None
            if flush:
                self._last_shed_event_t = now
                counts, self._shed_counts = self._shed_counts, {}
        metrics.SERVE_SHED.inc(n, tags={"deployment": self.deployment,
                                        "reason": reason})
        if quiet:
            emit_event("serve_overload",
                       f"deployment {self.deployment!r} is shedding "
                       f"({reason})", entity=(self.deployment,),
                       attrs={"reason": reason})
        if counts:
            emit_event("serve_shed",
                       f"deployment {self.deployment!r} shed "
                       f"{sum(counts.values())} request(s)",
                       entity=(self.deployment,), attrs=counts)

    def _shed(self, reason: str, queued: int, retry_after_s: float,
              detail: str):
        self.record_shed(reason)
        raise BackPressureError(
            f"request to deployment {self.deployment!r} shed: {detail}",
            deployment=self.deployment, reason=reason, queued=queued,
            retry_after_s=retry_after_s)

    def admission_stats(self) -> Optional[dict]:
        """Queue/shed visibility for /v1/stats (None with the plane off)."""
        b = self._budgets
        if b is None or not CONFIG.serve_admission:
            return None
        qdl = b.get("queue_deadline_s")
        with self._lock:
            return {"queued": self._queued, "shed_total": self._shed_total,
                    "max_ongoing_requests": int(b.get("max_ongoing", 16)),
                    "max_queued_requests": int(b.get("max_queued", -1)),
                    "queue_deadline_s": (float(CONFIG.serve_queue_deadline_s)
                                         if qdl is None else float(qdl))}

    def _pick_free_locked(self, cap: int, multiplexed_model_id: str):
        """Pow-2 choices among replicas with a FREE slot (outstanding under
        the deployment's per-replica cap); None when every replica is at
        capacity. Lock held by the caller. Multiplexed requests keep the
        hot-replica preference, constrained to free replicas."""
        reps = self._replicas
        if multiplexed_model_id and reps:
            known = self._model_replicas.get(multiplexed_model_id, ())
            hot = [(r, h) for r, h in reps if r in known]
            if hot:
                floor = min(self._outstanding.get(r, 0) for r, _h in reps)
                hot_floor = min(self._outstanding.get(r, 0)
                                for r, _h in hot)
                if hot_floor - floor <= 2:
                    reps = hot
        free = [(r, h) for r, h in reps
                if self._outstanding.get(r, 0) < cap]
        if not free:
            return None
        if len(free) == 1:
            return free[0]
        (r1, h1), (r2, h2) = random.sample(free, 2)
        if self._outstanding.get(r1, 0) <= self._outstanding.get(r2, 0):
            return r1, h1
        return r2, h2

    def _demand_ping(self):
        try:
            ctrl = ray_tpu_torch.get_actor(self.controller_name)
            ctrl.notify_demand.remote(self.deployment)
        except Exception:
            pass

    def _admit(self, budgets: dict, timeout: float,
               multiplexed_model_id: str,
               cancel: Optional[threading.Event]):
        """Bounded-queue admission (README "Overload & admission control"):
        reserve a replica slot under the deployment's concurrency cap, or
        wait in the bounded queue until one frees — shedding with a typed
        BackPressureError when the queue is full or the deadline passes,
        NEVER stalling past it. Returns (rid, handle) with the slot
        already reserved (outstanding incremented)."""
        from ray_tpu_torch.util import metrics

        cap = max(1, int(budgets.get("max_ongoing", 16)))
        max_queued = int(budgets.get("max_queued", -1))
        qdl = budgets.get("queue_deadline_s")
        qdl = float(CONFIG.serve_queue_deadline_s) if qdl is None else float(qdl)
        deadline = time.monotonic() + max(0.0, min(timeout, qdl))
        retry_after = min(2.0, max(0.1, qdl / 4.0))
        last_demand_ping = 0.0
        tags = {"deployment": self.deployment}
        with self._slots:
            # Fast path first: a free slot now means no queue entry at all.
            picked = self._pick_free_locked(cap, multiplexed_model_id)
            if picked is None and 0 <= max_queued <= self._queued:
                self._shed("queue_full", self._queued, retry_after,
                           f"queue full ({self._queued}/{max_queued} "
                           f"queued, {cap} executing per replica)")
            enqueued = picked is None
            if enqueued:
                self._queued += 1
                metrics.SERVE_QUEUE_DEPTH.set(self._queued, tags=tags)
            try:
                while picked is None:
                    if cancel is not None and cancel.is_set():
                        raise QueueCancelled(self.deployment)
                    now = time.monotonic()
                    if not self._replicas and now - last_demand_ping >= 1.0:
                        # Scale-from-zero demand signal (see the legacy
                        # path); the RPC submit must not hold the lock.
                        last_demand_ping = now
                        self._slots.release()
                        try:
                            self._demand_ping()
                        finally:
                            self._slots.acquire()
                        continue  # membership may have changed meanwhile
                    left = deadline - now
                    if left <= 0:
                        self._shed("deadline", self._queued, retry_after,
                                   f"no replica slot within {qdl}s "
                                   f"(queue_deadline_s)")
                    # Bounded waits: the cancel event has no notifier, so
                    # poll it at 100ms granularity.
                    self._slots.wait(timeout=min(left, 0.1))
                    picked = self._pick_free_locked(cap, multiplexed_model_id)
            finally:
                if enqueued:
                    self._queued = max(0, self._queued - 1)
                    metrics.SERVE_QUEUE_DEPTH.set(self._queued, tags=tags)
            rid, handle = picked
            self._outstanding[rid] = self._outstanding.get(rid, 0) + 1
            return rid, handle

    # --------------------------------------------------------------- assign
    def assign(self, method_name: str, args: tuple, kwargs: dict,
               timeout: float = 30.0, multiplexed_model_id: str = "",
               streaming: bool = False, stream_ring: Optional[dict] = None,
               cancel: Optional[threading.Event] = None,
               meta: Optional[dict] = None, bypass_queue: bool = False):
        """Pick a replica and dispatch; returns the result ObjectRef — or,
        with streaming=True, an ObjectRefGenerator of incremental results
        (the replica method runs as a streaming generator; reference
        serve's streaming response path over RequestRouter).
        `stream_ring` (streaming only) asks the replica to deliver items
        over a shm StreamRing instead of per-item streamed ObjectRefs
        (README "Serving hot loop"); None keeps the classic reply path
        byte-identical. Multiplexed requests prefer replicas this router
        already routed the model to (reference multiplex cache locality),
        then fall back to pow-2-choices balancing.

        With admission on (RT_SERVE_ADMISSION + budgets on the routing
        frame) assignment goes through the bounded queue and may raise
        BackPressureError (see _admit); `cancel` aborts a QUEUED request
        on client disconnect, `meta` (a dict) receives the chosen
        replica_id for failure attribution, and `bypass_queue` exempts
        operator introspection (stats) so the queue stays observable
        exactly when it is full."""
        admitted = (CONFIG.serve_admission and self._budgets is not None
                    and not bypass_queue)
        if admitted:
            rid, handle = self._admit(self._budgets, timeout,
                                      multiplexed_model_id, cancel)
        else:
            rid, handle = self._pick_legacy(timeout, multiplexed_model_id)
            with self._lock:
                self._outstanding[rid] = self._outstanding.get(rid, 0) + 1
        if meta is not None:
            meta["replica_id"] = rid
        # Stats probes that bypassed the queue also bypass the replica's
        # hard cap — observability must work exactly when saturated.
        bypass_cap = bool(bypass_queue and CONFIG.serve_admission)
        return self._dispatch(rid, handle, method_name, args, kwargs,
                              multiplexed_model_id, streaming, stream_ring,
                              bypass_cap=bypass_cap)

    def _pick_legacy(self, timeout: float, multiplexed_model_id: str):
        """The pre-admission replica pick: spin against membership with a
        flat timeout, no caps, no queue bound (byte-identical legacy path,
        pinned by the RT_SERVE_ADMISSION=0 test)."""
        deadline = time.monotonic() + timeout
        last_demand_ping = 0.0
        while True:
            if not self._have_replicas.is_set():
                # Zero replicas with a request in hand: tell the controller
                # so a min_replicas=0 deployment scales FROM zero on
                # traffic (reference: router demand metrics feed
                # autoscaling). Once per second per waiting request.
                now = time.monotonic()
                if now - last_demand_ping >= 1.0:
                    last_demand_ping = now
                    try:
                        ctrl = ray_tpu_torch.get_actor(self.controller_name)
                        ctrl.notify_demand.remote(self.deployment)
                    except Exception:
                        pass
            left = deadline - time.monotonic()
            # A set event returns from wait() immediately, so the 1s cap
            # only bounds the no-replica polls between demand pings.
            if left <= 0 or not self._have_replicas.wait(
                    timeout=min(left, 1.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"no ready replicas for deployment "
                        f"{self.deployment!r}")
                continue
            with self._lock:
                reps = self._replicas
                if multiplexed_model_id and reps:
                    known = self._model_replicas.get(multiplexed_model_id, ())
                    hot = [(r, h) for r, h in reps if r in known]
                    if hot:
                        # Spill to cold replicas when every hot one is
                        # clearly busier than the least-loaded replica —
                        # a popular model must not be capped at one
                        # replica's throughput.
                        floor = min(self._outstanding.get(r, 0)
                                    for r, _h in reps)
                        hot_floor = min(self._outstanding.get(r, 0)
                                        for r, _h in hot)
                        if hot_floor - floor <= 2:
                            reps = hot
                if not reps:
                    pass  # emptied between the event wait and the lock
                elif len(reps) == 1:
                    rid, handle = reps[0]
                    break
                else:
                    (r1, h1), (r2, h2) = random.sample(reps, 2)
                    if self._outstanding.get(r1, 0) <= self._outstanding.get(r2, 0):
                        rid, handle = r1, h1
                    else:
                        rid, handle = r2, h2
                    break
            time.sleep(0.02)  # rare: replica set emptied mid-assign
        return rid, handle

    def _dispatch(self, rid: str, handle, method_name: str, args: tuple,
                  kwargs: dict, multiplexed_model_id: str, streaming: bool,
                  stream_ring: Optional[dict], bypass_cap: bool = False):
        """Dispatch to the picked replica (slot already reserved) and track
        the result ref so the drain loop releases the slot on completion."""
        with self._lock:
            if multiplexed_model_id:
                lst = self._model_replicas.pop(multiplexed_model_id, [])
                if rid not in lst:
                    lst.append(rid)
                # Re-insert at the end so the bound below evicts the
                # least-recently-ROUTED id, not merely the oldest-inserted
                # (a still-hot model must survive one-off stale ids).
                self._model_replicas[multiplexed_model_id] = lst
                # Bound the map: ids are client-supplied (HTTP header) and
                # must not leak memory in a long-running proxy.
                while len(self._model_replicas) > 512:
                    self._model_replicas.pop(
                        next(iter(self._model_replicas)))
        if streaming:
            skw = {"multiplexed_model_id": multiplexed_model_id}
            if stream_ring is not None:
                skw["stream_ring"] = stream_ring
            if bypass_cap:
                skw["bypass_cap"] = True
            gen = handle.handle_request_streaming.options(
                num_returns="streaming").remote(
                    method_name, args, kwargs, **skw)
            with self._lock:
                # The completion sentinel resolves when the stream ends —
                # exactly when the request stops being "outstanding".
                self._tracked[gen.completed()] = rid
            return gen
        ukw = {"multiplexed_model_id": multiplexed_model_id}
        if bypass_cap:
            ukw["bypass_cap"] = True
        ref = handle.handle_request.remote(method_name, args, kwargs, **ukw)
        with self._lock:
            self._tracked[ref] = rid
        return ref

    def close(self):
        self.dead = True
        self._closed.set()


class DeploymentResponse:
    """reference serve/handle.py DeploymentResponse: a future for one
    request; .result() retries once on replica death (the router has
    already learned about the dead replica via long-poll by then)."""

    def __init__(self, router: Router, method_name: str, args, kwargs, ref,
                 multiplexed_model_id: str = ""):
        self._router = router
        self._method = method_name
        self._args, self._kwargs = args, kwargs
        self._ref = ref
        self._model_id = multiplexed_model_id

    def result(self, timeout_s: float = 60.0):
        from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError

        if not CONFIG.serve_admission:
            try:
                return ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except (ActorDiedError, WorkerCrashedError):
                # replica died mid-request: route to a survivor once
                self._ref = self._router.assign(
                    self._method, self._args, self._kwargs,
                    multiplexed_model_id=self._model_id)
                return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        # Admission on: replica-death (and cross-router replica_busy)
        # failures re-assign against survivors under a per-request retry
        # budget with jittered backoff — a killed replica's backlog drains
        # through the survivors instead of failing at the first death.
        deadline = time.monotonic() + timeout_s
        retries = max(0, int(CONFIG.serve_retries))
        for attempt in range(retries + 1):
            try:
                return ray_tpu_torch.get(
                    self._ref,
                    timeout=max(0.1, deadline - time.monotonic()))
            except (ActorDiedError, WorkerCrashedError) as e:
                if attempt >= retries:
                    raise
                logger.debug("serve response retry %d after %r",
                             attempt + 1, e)
            except Exception as e:
                if not _is_replica_busy(e) or attempt >= retries:
                    raise
            time.sleep(_retry_pause_s(attempt))
            self._ref = self._router.assign(
                self._method, self._args, self._kwargs,
                timeout=max(0.1, deadline - time.monotonic()),
                multiplexed_model_id=self._model_id)

    def __await__(self):
        """`await handle.method.remote(x)` inside async deployments —
        costs no thread while the downstream request runs (one shared
        resolver thread per loop; reference DeploymentResponse is
        awaitable the same way)."""
        return self._aresult().__await__()

    async def _aresult(self):
        import asyncio

        from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError

        resolver = resolver_for(asyncio.get_event_loop())
        if not CONFIG.serve_admission:
            try:
                return await resolver.submit(self._ref)
            except (ActorDiedError, WorkerCrashedError):
                self._ref = self._router.assign(
                    self._method, self._args, self._kwargs,
                    multiplexed_model_id=self._model_id)
                return await resolver.submit(self._ref)
        retries = max(0, int(CONFIG.serve_retries))
        for attempt in range(retries + 1):
            try:
                return await resolver.submit(self._ref)
            except (ActorDiedError, WorkerCrashedError) as e:
                if attempt >= retries:
                    raise
                logger.debug("serve response retry %d after %r",
                             attempt + 1, e)
            except Exception as e:
                if not _is_replica_busy(e) or attempt >= retries:
                    raise
            await asyncio.sleep(_retry_pause_s(attempt))
            # assign can park in the admission queue: keep it off the loop.
            self._ref = await asyncio.get_event_loop().run_in_executor(
                None, lambda: self._router.assign(
                    self._method, self._args, self._kwargs,
                    multiplexed_model_id=self._model_id))

    def _to_object_ref(self):
        return self._ref


class DeploymentHandle:
    """Picklable handle (reference serve/handle.py:DeploymentHandle):
    carries (controller_name, deployment); the per-process router is
    reconstructed lazily after unpickle, so handles can be passed into
    other deployments for model composition."""

    def __init__(self, deployment: str,
                 controller_name: str = "_serve_controller",
                 method_name: str = "__call__",
                 multiplexed_model_id: str = "",
                 stream: bool = False):
        self.deployment = deployment
        self.controller_name = controller_name
        self.method_name = method_name
        self.multiplexed_model_id = multiplexed_model_id
        self.stream = stream

    @property
    def _router(self) -> Router:
        return get_router(self.controller_name, self.deployment)

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment, self.controller_name,
            method_name if method_name is not None else self.method_name,
            multiplexed_model_id if multiplexed_model_id is not None
            else self.multiplexed_model_id,
            stream if stream is not None else self.stream)

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment, self.controller_name, name,
                                self.multiplexed_model_id, self.stream)

    def remote(self, *args, **kwargs):
        if self.stream:
            # ObjectRefGenerator of incremental results (reference
            # handle.options(stream=True) -> DeploymentResponseGenerator).
            return self._router.assign(
                self.method_name, args, kwargs,
                multiplexed_model_id=self.multiplexed_model_id,
                streaming=True)
        ref = self._router.assign(
            self.method_name, args, kwargs,
            multiplexed_model_id=self.multiplexed_model_id)
        return DeploymentResponse(self._router, self.method_name, args,
                                  kwargs, ref,
                                  multiplexed_model_id=self.multiplexed_model_id)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment, self.controller_name, self.method_name,
                 self.multiplexed_model_id, self.stream))

    def __repr__(self):
        return f"DeploymentHandle({self.deployment!r})"

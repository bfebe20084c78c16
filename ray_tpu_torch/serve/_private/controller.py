"""Serve controller: reconciles declared deployments into replica actors.

Parity target: reference python/ray/serve/_private/controller.py:86
(ServeController.run_control_loop) + deployment_state.py:1248,2343 (the
reconciler: scale up/down, rolling updates, health checks) +
long_poll.py (LongPollHost — version-gated config push to routers/proxies)
+ autoscaling_policy.py (ongoing-requests-based replica count).

One async actor; the reconcile loop runs as a background task on its event
loop. Routing state is versioned; get_routing()/route_table() long-poll
until the version advances (or time out), which is how routers and proxies
learn about replica membership changes without polling hot loops.

Counterpart: ray_tpu/serve/_private/controller.py (copied).
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
import uuid
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch._private.events import emit_event

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "_serve_controller"
PROXY_NAME = "_serve_proxy"
RECONCILE_INTERVAL_S = 0.2
AUTOSCALE_INTERVAL_S = 0.5
HEALTH_INTERVAL_S = 1.0
DOWNSCALE_PATIENCE = 4  # consecutive intervals below target before shrink


class _DeploymentState:
    def __init__(self, spec: dict):
        self.spec = spec
        self.replicas: dict[str, dict] = {}  # rid -> {handle, ready}
        self.stopping: list = []  # handles being drained
        self.low_ticks = 0  # autoscale downscale patience
        self.target = self._initial_target()

    def _initial_target(self) -> int:
        n = self.spec.get("num_replicas", 1)
        if self.spec.get("autoscaling_config"):
            return int(self.spec["autoscaling_config"].get("min_replicas", 1))
        return int(n)

    def ready_replicas(self) -> list[tuple[str, Any]]:
        return [(rid, r["handle"]) for rid, r in self.replicas.items()
                if r["ready"]]


class ServeController:
    def __init__(self):
        self.deployments: dict[str, _DeploymentState] = {}
        self.routes: dict[str, str] = {}  # route_prefix -> deployment name
        self.version = 0
        self._version_event: Optional[asyncio.Event] = None
        self._loop_task = None
        self._shutdown = False
        # rolling updates: deployment -> old-generation replicas still
        # serving until the new generation is ready
        self._retire_after_ready: dict[str, dict] = {}
        self._health_inflight: set[str] = set()
        # HTTP proxy fleet registry (README "Cross-host streaming &
        # multi-proxy"): proxy_id -> {host, port, pid}. Proxies register
        # on ready() — including after a restart, which is how a SIGKILLed
        # proxy rejoins the fleet — and serve.proxy_ports() reads it.
        self._proxies: dict[str, dict] = {}

    # ------------------------------------------------------------ plumbing
    def _ensure_loop(self):
        if self._version_event is None:
            self._version_event = asyncio.Event()
        if self._loop_task is None:
            self._loop_task = asyncio.ensure_future(self._control_loop())

    def _bump(self):
        self.version += 1
        if self._version_event is not None:
            self._version_event.set()
            self._version_event = asyncio.Event()

    async def _wait_version(self, known: int, timeout: float):
        deadline = time.monotonic() + timeout
        while self.version == known and not self._shutdown:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            self._ensure_loop()
            try:
                await asyncio.wait_for(asyncio.shield(self._version_event.wait()),
                                       timeout=min(left, 1.0))
            except asyncio.TimeoutError:
                pass

    # ------------------------------------------------------------- public
    async def deploy(self, spec: dict) -> None:
        """Register (or update) a deployment; reconciliation is async —
        poll status() for readiness (reference deploy path: client.deploy ->
        wait_for_deployment_healthy)."""
        self._ensure_loop()
        name = spec["name"]
        cur = self.deployments.get(name)
        if cur is not None and cur.spec.get("version") == spec.get("version"):
            # config-only update (e.g. num_replicas): keep replicas
            cur.spec = spec
            if not spec.get("autoscaling_config"):
                cur.target = int(spec.get("num_replicas", 1))
        else:
            st = _DeploymentState(spec)
            if cur is not None:
                # rolling update: keep old replicas serving; they are
                # retired once the new generation is ready. If an even
                # older generation is still parked here (two rapid
                # deploys), stop it now — nothing routes to it anymore.
                stale = self._retire_after_ready.pop(name, None)
                if stale:
                    for r in stale.values():
                        asyncio.ensure_future(self._stop_replica(r["handle"]))
                self._retire_after_ready[name] = cur.replicas
            self.deployments[name] = st
        prefix = spec.get("route_prefix")
        if prefix:
            self.routes = {p: d for p, d in self.routes.items() if d != name}
            self.routes[prefix] = name
        emit_event("serve_deploy",
                   f"deployment {name!r} "
                   f"{'updated' if cur is not None else 'created'} "
                   f"(target {self.deployments[name].target})",
                   entity=(name,),
                   attrs={"target": self.deployments[name].target,
                          "update": cur is not None})
        self._bump()

    async def get_routing(self, deployment: str, known_version: int = -1,
                          timeout: float = 10.0) -> dict:
        if known_version == self.version:
            await self._wait_version(known_version, timeout)
        st = self.deployments.get(deployment)
        reps = st.ready_replicas() if st else []
        # During a rolling update the outgoing generation keeps serving
        # until the new one is ready (no dropped requests).
        retire = self._retire_after_ready.get(deployment)
        if retire and not reps:
            reps = [(rid, r["handle"]) for rid, r in retire.items() if r["ready"]]
        out = {"version": self.version, "replicas": reps}
        from ray_tpu_torch._private.rtconfig import CONFIG

        if CONFIG.serve_admission and st is not None:
            # Admission budgets ride the same long-poll frame as
            # membership, so routers learn cap changes exactly when they
            # learn replica changes. Absent entirely with the plane off —
            # the frame stays byte-identical to the pre-admission shape.
            out["budgets"] = {
                "max_ongoing": int(st.spec.get("max_ongoing_requests", 16)),
                "max_queued": int(st.spec.get("max_queued_requests", -1)),
                "queue_deadline_s": st.spec.get("queue_deadline_s"),
            }
        return out

    async def route_table(self, known_version: int = -1,
                          timeout: float = 10.0) -> dict:
        if known_version == self.version:
            await self._wait_version(known_version, timeout)
        return {"version": self.version, "routes": dict(self.routes)}

    async def status(self) -> dict:
        out = {}
        for name, st in self.deployments.items():
            ready = len(st.ready_replicas())
            out[name] = {
                "target": st.target,
                "ready": ready,
                # target==0 is a VALID steady state for scaled-to-zero
                # deployments (min_replicas=0), not an in-progress update.
                "status": ("RUNNING" if ready >= st.target
                           and (st.target > 0 or self._scale_to_zero_ok(st))
                           else "UPDATING"),
            }
        return out

    async def register_proxy(self, proxy_id: str, host: str, port: int,
                             pid: int) -> None:
        """Called by each HTTP proxy from ready(). Re-registration under
        the same proxy_id (a restarted proxy, whose port/pid changed) is
        an update, not an error — that IS the rejoin contract."""
        self._proxies[proxy_id] = {
            "host": host, "port": int(port), "pid": int(pid)}

    async def list_proxies(self) -> dict:
        """proxy_id -> {host, port, pid} for every proxy that has come up.
        Backs serve.proxy_ports() and the /v1/stats fleet aggregation."""
        return {k: dict(v) for k, v in self._proxies.items()}

    async def delete(self, name: str):
        st = self.deployments.pop(name, None)
        self.routes = {p: d for p, d in self.routes.items() if d != name}
        if st is not None:
            for rid, r in st.replicas.items():
                asyncio.ensure_future(self._stop_replica(r["handle"]))
        retired = self._retire_after_ready.pop(name, None)
        if retired:
            for r in retired.values():
                asyncio.ensure_future(self._stop_replica(r["handle"]))
        self._bump()

    async def shutdown_all(self):
        self._shutdown = True
        for name in list(self.deployments):
            await self.delete(name)
        return True

    # ----------------------------------------------------------- reconcile
    async def _control_loop(self):
        last_autoscale = 0.0
        last_health = 0.0
        while not self._shutdown:
            try:
                now = time.monotonic()
                for name, st in list(self.deployments.items()):
                    await self._reconcile(name, st)
                if now - last_autoscale >= AUTOSCALE_INTERVAL_S:
                    last_autoscale = now
                    for name, st in list(self.deployments.items()):
                        if st.spec.get("autoscaling_config"):
                            await self._autoscale(name, st)
                if now - last_health >= HEALTH_INTERVAL_S:
                    last_health = now
                    for name, st in list(self.deployments.items()):
                        for rid, r in list(st.replicas.items()):
                            if r["ready"] and rid not in self._health_inflight:
                                self._health_inflight.add(rid)
                                asyncio.ensure_future(
                                    self._check_replica(name, st, rid, r["handle"]))
            except Exception:
                logger.exception("serve controller reconcile error")
            await asyncio.sleep(RECONCILE_INTERVAL_S)

    async def _check_replica(self, name: str, st: _DeploymentState,
                             rid: str, handle):
        """Dead-replica detection (reference deployment_state health checks):
        an unhealthy replica leaves the routing table immediately; the
        reconciler replaces it on the next tick."""
        try:
            await self._async_get(handle.health_check.remote(), timeout=5)
        except Exception as e:
            if (name in self.deployments and self.deployments[name] is st
                    and st.replicas.pop(rid, None) is not None):
                logger.warning("serve: replica %s failed health check (%r); "
                               "replacing", rid, e)
                emit_event("serve_replica_death",
                           f"replica {rid} failed its health check ({e!r}); "
                           f"replacing", entity=(name, rid))
                self._bump()
                # Actually stop it: a live-but-stuck replica would otherwise
                # keep its actor + resource reservation forever, starving
                # the replacement.
                asyncio.ensure_future(self._stop_replica(handle))
        finally:
            self._health_inflight.discard(rid)

    async def _reconcile(self, name: str, st: _DeploymentState):
        # Scale up.
        while len(st.replicas) < st.target:
            self._start_replica(name, st)
        # Promote replicas whose ready() resolved. wait/get are synchronous
        # cluster RPCs; even a timeout=0 poll pays a controller round trip,
        # so both hop through the executor — this loop shares the actor's
        # event loop with the long-poll handlers and health replies.
        for rid, r in list(st.replicas.items()):
            if not r["ready"] and r["ready_ref"] is not None:
                done, _ = await self._async_wait([r["ready_ref"]])
                if not done:
                    continue
                err = None
                try:
                    await self._async_get(done[0], timeout=1)
                except Exception as e:
                    err = e
                if self.deployments.get(name) is not st:
                    # Superseded mid-await: st.replicas may now BE the
                    # retire set deploy() parked in _retire_after_ready —
                    # popping a failed replica from it here would exempt
                    # that actor from the retire sweep and leak it.
                    return
                if err is None:
                    r["ready"] = True
                    r["ready_ref"] = None
                    self._bump()
                else:
                    logger.warning("serve: replica %s failed to start: %r",
                                   rid, err)
                    emit_event("serve_replica_death",
                               f"replica {rid} failed to start: {err!r}",
                               entity=(name, rid), attrs={"start": True})
                    st.replicas.pop(rid, None)
        # The executor hops above are suspension points the old sync
        # wait/get never had: a deploy() landing mid-await swaps
        # self.deployments[name] to a NEW generation's state and points
        # _retire_after_ready at the generation WE hold. Running the
        # retire/scale-down logic against the stale st would count the old
        # generation's own replicas as "the new one is ready" and stop it
        # before its successor serves — bail out and let the next tick
        # reconcile the live state.
        if self.deployments.get(name) is not st:
            return
        # Finish a rolling update: retire the old generation once the new
        # one is fully ready.
        old = self._retire_after_ready.get(name)
        if old and len(st.ready_replicas()) >= max(1, st.target):
            self._retire_after_ready.pop(name, None)
            self._bump()  # routers switch to the new generation NOW
            for rid, r in old.items():
                asyncio.ensure_future(self._stop_replica(r["handle"]))
        # Scale down (newest first, like the reference's replica selection).
        while len(st.replicas) > st.target:
            rid = next(reversed(st.replicas))
            r = st.replicas.pop(rid)
            self._bump()
            asyncio.ensure_future(self._stop_replica(r["handle"]))

    def _start_replica(self, name: str, st: _DeploymentState):
        spec = st.spec
        rid = f"{name}#{uuid.uuid4().hex[:6]}"
        opts = dict(spec.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 1)
        cap = int(spec.get("max_ongoing_requests", 16))
        opts["max_concurrency"] = cap
        from ray_tpu_torch._private.rtconfig import CONFIG
        from ray_tpu_torch.serve._private.replica import Replica

        extra: dict = {}
        if CONFIG.serve_admission:
            # With admission on, the replica enforces the cap itself
            # (typed replica_busy rejection the routers retry elsewhere).
            # The actor concurrency limit gets headroom above the cap so
            # control calls — stats, drain, the rejection itself — still
            # run while every request slot is occupied; without it a
            # saturated replica is also unobservable.
            opts["max_concurrency"] = cap + 8
            extra["max_ongoing"] = cap
        actor_cls = ray_tpu_torch.remote(**opts)(Replica)
        handle = actor_cls.remote(name, rid, spec["callable"],
                                  tuple(spec.get("init_args") or ()),
                                  dict(spec.get("init_kwargs") or {}),
                                  **extra)
        st.replicas[rid] = {"handle": handle, "ready": False,
                            "ready_ref": handle.ready.remote()}

    async def _stop_replica(self, handle):
        try:
            ref = handle.drain.remote(5.0)
            await self._async_get(ref, timeout=8)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    @staticmethod
    def _scale_to_zero_ok(st: "_DeploymentState") -> bool:
        cfg = st.spec.get("autoscaling_config") or {}
        return int(cfg.get("min_replicas", 1)) == 0

    async def notify_demand(self, name: str):
        """A router has requests waiting with ZERO replicas up: scale from
        zero immediately (reference: handle/router demand metrics feeding
        autoscaling so min_replicas=0 deployments wake on traffic)."""
        st = self.deployments.get(name)
        if st is None:
            return False
        # Only autoscaled scale-to-zero deployments wake on demand: an
        # operator who explicitly set num_replicas=0 paused the deployment
        # and a waiting client must not override that.
        if st.target < 1 and self._scale_to_zero_ok(st):
            logger.info("serve: scale-from-zero %s (router demand)", name)
            emit_event("serve_scale",
                       f"deployment {name!r} scale-from-zero 0 -> 1 "
                       f"(router demand)", entity=(name,),
                       attrs={"from": 0, "to": 1, "why": "demand"})
            st.target = 1
            st.low_ticks = 0
        return True

    async def _autoscale(self, name: str, st: _DeploymentState):
        cfg = st.spec["autoscaling_config"]
        lo = int(cfg.get("min_replicas", 1))
        hi = int(cfg.get("max_replicas", max(lo, 1)))
        target_ongoing = float(cfg.get("target_ongoing_requests", 2))
        target_latency = cfg.get("target_latency_ms")  # None = off
        reps = st.ready_replicas()
        if not reps:
            return
        total = 0
        lat_sum, lat_n = 0.0, 0
        for _rid, h in reps:
            try:
                s = await self._async_get(h.stats.remote(), timeout=2)
                total += s["ongoing"]
                if s.get("total"):
                    lat_sum += s.get("ema_latency_ms", 0.0)
                    lat_n += 1
            except Exception:
                pass
        desired = max(lo, min(hi, math.ceil(total / target_ongoing) or lo))
        if target_latency and lat_n:
            # Target-latency policy (reference autoscaling_policy's
            # latency-target variant): replicas scale with observed mean
            # latency over the target; combined with the ongoing-requests
            # policy by taking the tighter (larger) answer.
            mean_lat = lat_sum / lat_n
            by_latency = math.ceil(
                len(reps) * mean_lat / float(target_latency))
            desired = max(desired, min(hi, max(lo, by_latency)))
        if desired > st.target:
            logger.info("serve: autoscale %s %d -> %d (ongoing=%d)",
                        name, st.target, desired, total)
            emit_event("serve_scale",
                       f"deployment {name!r} autoscale {st.target} -> "
                       f"{desired} (ongoing={total})", entity=(name,),
                       attrs={"from": st.target, "to": desired,
                              "ongoing": total})
            st.target = desired
            st.low_ticks = 0
        elif desired < st.target:
            st.low_ticks += 1
            if st.low_ticks >= DOWNSCALE_PATIENCE:
                logger.info("serve: autoscale %s %d -> %d (ongoing=%d)",
                            name, st.target, desired, total)
                emit_event("serve_scale",
                           f"deployment {name!r} autoscale {st.target} -> "
                           f"{desired} (ongoing={total})", entity=(name,),
                           attrs={"from": st.target, "to": desired,
                                  "ongoing": total})
                st.target = desired
                st.low_ticks = 0
        else:
            st.low_ticks = 0

    @staticmethod
    async def _async_get(ref, timeout: float):
        """Await an ObjectRef without blocking the actor event loop."""
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(None, lambda: ray_tpu_torch.get(ref, timeout=timeout))

    @staticmethod
    async def _async_wait(refs, num_returns: int = 1, timeout: float = 0):
        """Poll ObjectRef readiness without blocking the actor event loop."""
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(
            None, lambda: ray_tpu_torch.wait(refs, num_returns=num_returns,
                                       timeout=timeout))

"""Autoscaler: demand-driven node scaling.

Parity target: reference autoscaler v2 (python/ray/autoscaler/v2/
autoscaler.py:42 + scheduler.py's demand bin-packing + instance_manager/):
a reconciler loop reads unmet resource demand from the controller, computes
the node delta against a provider's node shape, and launches/terminates
nodes through a pluggable NodeProvider. The bundled LocalNodeProvider
launches real NodeAgent subprocesses on this machine (reference
FakeMultiNodeProvider, autoscaler/_private/fake_multi_node/
node_provider.py:236 — the harness the reference's own autoscaler tests
use).

Counterpart: ray_tpu/autoscaler/__init__.py (copied; `LocalNodeProvider`
launches the port's node agent, which advertises the `node_shape` as
given, "GPU" included).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Optional

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.resources import ResourceSet

logger = logging.getLogger(__name__)


class NodeProvider:
    """Launches and terminates worker nodes of one shape.

    Reference: python/ray/autoscaler/node_provider.py (create_node,
    terminate_node, non_terminated_nodes) collapsed to the v2 essentials."""

    #: resources each new node contributes, e.g. {"CPU": 4}
    node_shape: dict

    def create_node(self) -> str:
        """Launch one node; returns its node_id."""
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> list[str]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Subprocess NodeAgents on this machine (testing / single-host)."""

    def __init__(self, address: str, session_id: str,
                 node_shape: Optional[dict] = None,
                 env: Optional[dict] = None):
        self.address = address
        self.session_id = session_id
        self.node_shape = dict(node_shape or {"CPU": 1.0})
        self.env = dict(env or {})
        self._procs: dict[str, subprocess.Popen] = {}

    def create_node(self) -> str:
        node_id = NodeID.from_random().hex()
        penv = dict(os.environ)
        penv.update(self.env)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        driver_paths = [p for p in sys.path if p and os.path.exists(p)]
        existing = penv.get("PYTHONPATH", "")
        penv["PYTHONPATH"] = os.pathsep.join(
            ([existing] if existing else []) + [pkg_root] + driver_paths)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node_agent",
             "--controller", self.address,
             "--node-id", node_id,
             "--session", self.session_id,
             "--resources", json.dumps(ResourceSet(self.node_shape).raw()),
             "--labels", json.dumps({"autoscaler": "true"})],
            env=penv)
        self._procs[node_id] = proc
        return node_id

    def terminate_node(self, node_id: str) -> None:
        proc = self._procs.pop(node_id, None)
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()

    def non_terminated_nodes(self) -> list[str]:
        return [nid for nid, p in self._procs.items() if p.poll() is None]


class Autoscaler:
    """Reconciler: poll demand -> bin-pack against capacity -> scale.

    Scale-up: any demand shape that fits NO alive node's available
    resources (and no pending launch) asks for new nodes, bin-packed onto
    the provider's node shape. Scale-down: autoscaler-launched nodes whose
    resources have been fully idle for `idle_timeout_s` are terminated
    (never below `min_workers`). Reference: v2 Autoscaler._run_once.
    """

    def __init__(self, address: str, provider: NodeProvider,
                 min_workers: int = 0, max_workers: int = 4,
                 idle_timeout_s: float = 30.0, interval_s: float = 1.0):
        self.provider = provider
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._io = rpc.EventLoopThread(name="autoscaler")
        self._conn: Optional[rpc.Connection] = None
        self._idle_since: dict[str, float] = {}
        # node_id -> launch time; in flight until it registers as alive
        # (or 60s passes — a crashed agent must not block scale-up forever).
        self._pending_launch: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _call(self, method: str, **kw):
        async def _go():
            if self._conn is None or self._conn.closed:
                self._conn = await rpc.connect(*self._addr)
                await self._conn.call("register", kind="client",
                                      worker_id=f"autoscaler-{os.getpid()}",
                                      address=None)
            return await self._conn.call(method, **kw)

        return self._io.run(_go(), timeout=30)

    # ---------------------------------------------------------- lifecycle
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rt-autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._io.stop()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                logger.exception("autoscaler iteration failed")

    # --------------------------------------------------------- reconcile
    @staticmethod
    def _fits(shape: dict, avail: dict) -> bool:
        return all(avail.get(k, 0.0) >= v for k, v in shape.items() if v > 0)

    def run_once(self):
        snap = self._call("state_snapshot")
        dem = self._call("resource_demand")
        provider_nodes = set(self.provider.non_terminated_nodes())
        alive = {nid: n for nid, n in snap["nodes"].items() if n["alive"]}
        now = time.monotonic()
        # A launch stops being "in flight" when ITS node registers (keyed by
        # node id — counting alive nodes against a timestamp list miscounts
        # as soon as any node outlives the window), or after 60s.
        self._pending_launch = {
            nid: t for nid, t in self._pending_launch.items()
            if nid not in alive and now - t < 60.0}
        n_inflight = len(self._pending_launch)

        # ---- scale up: demand no alive node can absorb
        avails = [dict(n["available"]) for n in alive.values()]
        unmet: list[dict] = []
        for shape in dem["demand"] + dem["pg_demand"]:
            if not shape:
                continue
            for av in avails:
                if self._fits(shape, av):
                    for k, v in shape.items():
                        av[k] = av.get(k, 0.0) - v  # consume, greedy pack
                    break
            else:
                unmet.append(shape)
        needed = 0
        if unmet:
            # Bin-pack unmet shapes onto fresh provider-shaped nodes.
            bins: list[dict] = []
            for shape in unmet:
                if not self._fits(shape, self.provider.node_shape):
                    continue  # can never fit this node type; skip
                for b in bins:
                    if self._fits(shape, b):
                        for k, v in shape.items():
                            b[k] -= v
                        break
                else:
                    b = dict(self.provider.node_shape)
                    for k, v in shape.items():
                        b[k] = b.get(k, 0.0) - v
                    bins.append(b)
            needed = len(bins)
        current = len(provider_nodes) + n_inflight
        deficit = max(self.min_workers - current, 0)
        to_launch = min(max(needed - n_inflight, deficit),
                        self.max_workers - current)
        for _ in range(max(0, to_launch)):
            nid = self.provider.create_node()
            self._pending_launch[nid] = now
            logger.info("autoscaler: launched node %s (%d in flight)",
                        nid[:8], len(self._pending_launch))

        # ---- scale down: fully-idle autoscaler nodes past the timeout
        if len(provider_nodes) <= self.min_workers:
            return
        for nid in list(provider_nodes):
            n = alive.get(nid)
            if n is None:
                continue
            # Job drivers consume no controller-visible resources; the
            # active_jobs count is the only signal a node is hosting one.
            idle = (n["available"] == n["total"]
                    and not n.get("active_jobs", 0))
            if not idle:
                self._idle_since.pop(nid, None)
                continue
            first = self._idle_since.setdefault(nid, now)
            if (now - first >= self.idle_timeout_s
                    and len(self.provider.non_terminated_nodes()) > self.min_workers):
                # Drain-then-verify: mark the node unschedulable, re-read its
                # state, and only kill it if it is STILL fully idle — work
                # dispatched between our snapshot and now must not die.
                self._call("drain_node", node_id=nid, on=True)
                fresh = self._call("state_snapshot")["nodes"].get(nid)
                if fresh is None or not fresh["alive"] or \
                        fresh["available"] != fresh["total"] or \
                        fresh.get("active_jobs", 0):
                    self._call("drain_node", node_id=nid, on=False)
                    self._idle_since.pop(nid, None)
                    continue
                logger.info("autoscaler: terminating idle node %s", nid[:8])
                self._idle_since.pop(nid, None)
                self.provider.terminate_node(nid)

    def close(self):
        self.stop()

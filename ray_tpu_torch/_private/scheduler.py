"""Cluster scheduling policies.

Parity target: reference raylet/scheduling/policy/ — hybrid (default: pack
until a node's utilization exceeds a threshold, then spread;
hybrid_scheduling_policy.h:50), spread, node-affinity, placement-group bundle
policies, composed like composite_scheduling_policy.h. Here the controller is
the single scheduler (GCS-side scheduling), which suits TPU pods: slices are
long-lived gang resources, so central decisions beat distributed spillback.

Counterpart: ray_tpu/_private/scheduler.py (copied).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch._private.task_spec import SchedulingStrategy


class NodeState:
    __slots__ = ("node_id", "address", "total", "available", "liveness",
                 "last_beat", "labels", "draining", "shm_used", "incarnation",
                 "suspect_since")

    def __init__(self, node_id: str, address: tuple, total: ResourceSet, labels: dict | None = None):
        self.node_id = node_id
        self.address = address
        self.total = total
        self.available = total.copy()
        # Liveness state machine (reference GcsNodeManager + health checks,
        # but with an explicit SUSPECT stage): ALIVE -> SUSPECT on
        # connection loss, SUSPECT -> ALIVE on re-registration within the
        # grace window, SUSPECT -> DEAD on expiry. DEAD is terminal for
        # this NodeState (a returning agent gets a fresh one).
        self.liveness = "ALIVE"  # ALIVE | SUSPECT | DEAD
        self.last_beat = 0.0
        self.labels = labels or {}
        # Draining (autoscaler scale-down handshake): schedulable = False.
        # The node keeps running what it has; nothing new lands on it.
        self.draining = False
        # Heartbeat-reported shm-resident bytes (spilled blocks excluded).
        self.shm_used = 0
        # Controller-minted, monotonically increasing per node_id: fences
        # messages and connection-close events from a previous life of
        # this node (a zombie agent can never mutate current state).
        self.incarnation = 0
        self.suspect_since = 0.0

    @property
    def alive(self) -> bool:
        """Schedulable / trusted-for-accounting. SUSPECT nodes are frozen:
        not schedulable, leases and actors kept but nothing new lands."""
        return self.liveness == "ALIVE"

    def utilization(self) -> float:
        scores = []
        for k, tot in self.total.raw().items():
            if tot <= 0:
                continue
            avail = self.available.raw().get(k, 0)
            scores.append(1.0 - avail / tot)
        return max(scores) if scores else 0.0


def pick_node(
    demand: ResourceSet,
    strategy: SchedulingStrategy,
    nodes: dict[str, NodeState],
    pg_bundles: Optional[dict] = None,
    preferred: Optional[dict] = None,
) -> Optional[str]:
    """Return node_id to run on, or None if nothing is feasible right now.

    `preferred` maps node_id -> argument bytes already resident there
    (locality, reference dependency_manager.h + the hybrid policy's
    locality preference): a DEFAULT-strategy task runs where its biggest
    arguments live when that node is feasible."""
    alive = {nid: n for nid, n in nodes.items() if n.alive and not n.draining}
    if not alive:
        return None

    if preferred and strategy.kind == "DEFAULT":
        best = None
        for nid, nbytes in preferred.items():
            n = alive.get(nid)
            if n is not None and n.available.fits(demand):
                if best is None or nbytes > best[1]:
                    best = (nid, nbytes)
        if best is not None:
            return best[0]

    if strategy.kind == "PLACEMENT_GROUP" and pg_bundles is not None:
        # Bundles carry their own reserved resources on a pinned node.
        return _pick_pg_node(demand, strategy, pg_bundles)

    if strategy.kind == "NODE_AFFINITY":
        node = alive.get(strategy.node_id)
        if node is not None and node.available.fits(demand):
            return node.node_id
        if strategy.soft:
            return _hybrid(demand, alive)
        # hard affinity: infeasible until that node frees up (or forever)
        return None

    if strategy.kind == "SPREAD":
        feasible = [n for n in alive.values() if n.available.fits(demand)]
        if not feasible:
            return None
        return min(feasible, key=lambda n: (n.utilization(), n.node_id)).node_id

    return _hybrid(demand, alive)


def _hybrid(demand: ResourceSet, alive: dict[str, NodeState]) -> Optional[str]:
    """Pack onto low-id nodes until utilization crosses the spread threshold,
    then prefer the least-utilized node (reference hybrid_scheduling_policy)."""
    feasible = [n for n in alive.values() if n.available.fits(demand)]
    if not feasible:
        return None
    thresh = CONFIG.scheduler_spread_threshold
    below = [n for n in feasible if n.utilization() <= thresh]
    if below:
        return min(below, key=lambda n: n.node_id).node_id
    return min(feasible, key=lambda n: (n.utilization(), n.node_id)).node_id


def _pick_pg_node(demand: ResourceSet, strategy: SchedulingStrategy, pg_bundles: dict) -> Optional[str]:
    """pg_bundles: {(pg_id, bundle_idx): {"node": nid, "available": ResourceSet}}"""
    if strategy.pg_bundle_index >= 0:
        key = (strategy.pg_id, strategy.pg_bundle_index)
        b = pg_bundles.get(key)
        if b is not None and b["available"].fits(demand):
            return b["node"]
        return None
    for (pgid, _idx), b in sorted(pg_bundles.items(), key=lambda kv: kv[0][1]):
        if pgid == strategy.pg_id and b["available"].fits(demand):
            return b["node"]
    return None

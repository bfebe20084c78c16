"""Chaos/fault-injection tooling for tests and resilience drills.

Parity target: reference python/ray/_private/test_utils.py:1386
(ResourceKillerActor / get_and_run_resource_killer — periodically kill
nodes under a live workload). Driver-side here: the Cluster test fixture
owns the node subprocesses, so the killer thread drives kill/add cycles
through it.

Counterpart: ray_tpu/util/chaos.py (copied; `NodeKiller` drives the
port's `Cluster`).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


class NodeKiller:
    """Periodically kills a random non-head node (and optionally replaces
    it) while a workload runs.

        killer = NodeKiller(cluster, interval_s=1.0, replace=True)
        killer.start()
        ... run workload ...
        killer.stop()
        assert killer.kills > 0
    """

    def __init__(self, cluster, *, interval_s: float = 1.0,
                 replace: bool = True, max_kills: Optional[int] = None,
                 node_resources: Optional[dict] = None, seed: int = 0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.replace = replace
        self.max_kills = max_kills
        self.node_resources = node_resources or {"num_cpus": 1}
        self.kills = 0
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-node-killer")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            if self._stop.wait(self.interval_s):
                return
            if self.max_kills is not None and self.kills >= self.max_kills:
                return
            victims = list(self.cluster.nodes)
            if not victims:
                continue
            victim = self._rng.choice(victims)
            try:
                self.cluster.remove_node(victim)
                self.kills += 1
                logger.warning("chaos: killed node %s", victim.node_id[:8])
            except Exception as e:
                logger.warning("chaos: kill failed: %r", e)
                continue
            if self.replace and not self._stop.is_set():
                try:
                    self.cluster.add_node(**self.node_resources)
                except Exception as e:
                    logger.warning("chaos: replace failed: %r", e)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

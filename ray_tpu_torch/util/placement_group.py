"""Placement groups: gang reservation of resource bundles across nodes.

Parity target: reference python/ray/util/placement_group.py
(placement_group(), strategies PACK/SPREAD/STRICT_PACK/STRICT_SPREAD) +
GcsPlacementGroupManager/Scheduler. The TPU-era significance: a pod slice is a
gang of hosts; STRICT_SPREAD bundles with per-host TPU chips express "one
worker per TPU host of the slice".

Counterpart: ray_tpu/util/placement_group.py (copied).
"""

from __future__ import annotations

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.worker import global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: list[dict]):
        self.id = pg_id
        self.bundles = bundles

    def ready(self):
        """Returns an ObjectRef resolving when the PG is placed (parity with
        reference pg.ready())."""
        from ray_tpu_torch.remote_function import RemoteFunction

        pg = self

        def _ready():
            return True

        return (
            RemoteFunction(_ready, {"num_cpus": 0, "placement_group": pg, "name": "pg_ready"})
            .remote()
        )

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        w = global_worker()
        rep = w.io.run(w.controller.call("pg_wait_ready", pg_id=self.id, timeout=timeout_seconds))
        return rep["ready"]

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles))


def placement_group(bundles: list[dict], strategy: str = "PACK", name: str = "") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy!r}; must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    w = global_worker()
    pg_id = PlacementGroupID.from_random().hex()
    raw = [ResourceSet(b).raw() for b in bundles]
    w.io.run(w.controller.call("create_pg", pg_id=pg_id, bundles=raw, strategy=strategy, name=name))
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    w = global_worker()
    w.io.run(w.controller.call("remove_pg", pg_id=pg.id))

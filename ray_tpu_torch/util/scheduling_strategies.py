"""Public scheduling strategy objects.

Parity target: reference python/ray/util/scheduling_strategies.py
(PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy).

Counterpart: ray_tpu/util/scheduling_strategies.py (copied).
"""

from __future__ import annotations

from dataclasses import dataclass

from ray_tpu_torch._private.task_spec import SchedulingStrategy


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="NODE_AFFINITY", node_id=self.node_id, soft=self.soft)


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def to_internal(self) -> SchedulingStrategy:
        pg = self.placement_group
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            pg_id=pg.id if hasattr(pg, "id") else pg,
            pg_bundle_index=self.placement_group_bundle_index,
            pg_capture_child_tasks=self.placement_group_capture_child_tasks,
        )

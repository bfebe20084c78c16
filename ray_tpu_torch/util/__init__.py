"""ray_tpu_torch.util — utility layer over the core runtime.

Parity target: reference python/ray/util/ — ActorPool, Queue,
multiprocessing.Pool, collective groups, placement groups, scheduling
strategies, the state API, and chaos tooling.

Counterpart: ray_tpu/util/__init__.py (copied).
"""

from ray_tpu_torch._private.watchdog import report_progress
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import placement_group
from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = [
    "ActorPool",
    "Empty",
    "Full",
    "Queue",
    "placement_group",
    "report_progress",
]

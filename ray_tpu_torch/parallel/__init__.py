"""The parallelism layer of the port: device meshes over torch.distributed
ranks, shardings, and differentiable collectives over mesh axes.

Counterpart: ray_tpu/parallel/__init__.py (the same exports). Where the
reference expresses collective math inside compiled XLA programs, every
rank here is a process holding its local shards, and each cross-rank step
is an explicit call in `parallel/collectives.py`.
"""

from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    data_sharding,
    local_mesh,
    replicated,
    shard_params,
)

__all__ = [
    "MeshConfig",
    "build_mesh",
    "local_mesh",
    "data_sharding",
    "replicated",
    "shard_params",
]

"""ray_tpu_torch.air — shared config/result surface (reference
python/ray/air: air/config.py ScalingConfig/RunConfig/FailureConfig/
CheckpointConfig, air/result.py Result). Canonical definitions live in
ray_tpu_torch.train.

Counterpart: ray_tpu/air/__init__.py (copied).
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._internal.controller import Result
from ray_tpu_torch.air import session

__all__ = ["Checkpoint", "CheckpointConfig", "FailureConfig", "RunConfig",
           "ScalingConfig", "Result", "session"]

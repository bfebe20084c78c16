"""Train/AIR configuration dataclasses.

Parity target: reference python/ray/air/config.py (ScalingConfig,
RunConfig, FailureConfig, CheckpointConfig) and ray/train usage of them.
Training runs on the card unless the caller asks for the CPU:
`use_gpu` defaults to True.

Counterpart: ray_tpu/train/config.py (ported: `use_gpu` in place of
`use_tpu` and `topology`, `torch_distributed` in place of `jax_distributed`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ScalingConfig:
    """How many training workers and what each one needs
    (reference air/config.py ScalingConfig)."""

    num_workers: int = 1
    #: One card per worker (resource "GPU"); False trains on the CPU.
    use_gpu: bool = True
    resources_per_worker: Optional[dict] = None
    #: Join every worker into one `torch.distributed` process group (NCCL
    #: when every worker holds a card of its own, gloo on the CPU and for
    #: workers that share a card): rank 0 reserves the rendezvous port and
    #: publishes it through the controller KV.
    torch_distributed: bool = False
    #: Extra env vars for worker processes, applied BEFORE any import in
    #: the worker (e.g. CUDA_VISIBLE_DEVICES or a torch setting that must
    #: be in place before the worker first imports torch).
    worker_env: Optional[dict] = None
    #: Elastic lower bound (reference train v2 ScalingPolicy): on a group
    #: failure the restart sizes itself to what the cluster can actually
    #: place — min_workers..num_workers — instead of waiting forever for
    #: the full quorum (training resumes from the checkpoint with data
    #: re-split over the surviving workers). None = fixed-size restarts.
    min_workers: Optional[int] = None

    def worker_resources(self) -> dict:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        if self.use_gpu:
            return {"CPU": 1, "GPU": 1}
        return {"CPU": 1}


@dataclass
class FailureConfig:
    """Elastic-recovery policy (reference air FailureConfig + train v2
    FailurePolicy, failure_handling/failure_policy.py:14): on worker/node
    failure the whole group restarts from the latest checkpoint."""

    max_failures: int = 0  # 0 = fail fast; -1 = unlimited restarts
    #: Group-stall policy (README "Stall detection & watchdogs"): a group
    #: that commits NO progress (no report() drained from any worker) for
    #: this long is treated as a group FAILURE — killed and restarted from
    #: the latest committed checkpoint through the same elastic path as a
    #: crash. Closes the silent-hang gap (a rank wedged in a collective
    #: stops the whole group from reporting, but nothing crashes). None =
    #: disabled.
    stall_timeout_s: Optional[float] = None


@dataclass
class CheckpointConfig:
    """num_to_keep: prune all but the N most recent checkpoints (enforced by
    the controller as reports arrive). checkpoint_frequency is accepted for
    reference-API compatibility but NOT honored — checkpointing cadence is
    whatever the user's train loop reports (a warning is logged if set)."""

    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0

    def __post_init__(self):
        if self.checkpoint_frequency:
            import logging

            logging.getLogger(__name__).warning(
                "CheckpointConfig.checkpoint_frequency is not honored; "
                "checkpoint from your train loop via train.report(checkpoint=...)")


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    #: Tune stop criteria: {"metric": threshold} — a trial stops once any
    #: reported metric reaches its threshold (reference air.RunConfig stop).
    stop: Optional[dict] = None

    def resolved_storage(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")

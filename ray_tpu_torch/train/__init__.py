"""ray_tpu_torch.train — distributed training on the cluster runtime.

Parity target: reference python/ray/train (TorchTrainer /
DataParallelTrainer, base_trainer.py:651 fit; the v2 controller loop;
session report/get_checkpoint/get_dataset_shard; worker_group actor
fleet).

A training worker is one actor process. With `ScalingConfig(use_gpu=True)`
(the default) it holds one card and the user's loop runs its model there;
across workers, gradient/metric sync rides the host-tier collective group
the session joins at startup (`train.torch_utils.sync_gradients`), or,
with `torch_distributed=True`, a `torch.distributed` process group (NCCL
when every worker holds a card of its own, gloo on the CPU and for workers
that share a card) that the loop drives itself, for instance through a
sharded model over `torch_utils.global_mesh_from_distributed()`.

Counterpart: ray_tpu/train/__init__.py (ported: `TorchTrainer` plays
`JaxTrainer`, with the same arguments and `fit()`).
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._internal.controller import Result, TrainController
from ray_tpu_torch.train._internal.session import TrainContext, get_session


def report(metrics: dict, checkpoint: Checkpoint | None = None):
    """Report metrics (+ optional checkpoint) from inside
    train_loop_per_worker (reference train/_internal/session.py:672)."""
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return TrainContext(get_session())


def get_checkpoint() -> Checkpoint | None:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


class TorchTrainer:
    """Data-parallel trainer over a worker group of actors.

    reference equivalents: DataParallelTrainer (data_parallel_trainer.py:26)
    + TorchTrainer; `.fit()` = base_trainer.py:651.
    """

    def __init__(self, train_loop_per_worker, *, train_loop_config=None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None):
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._datasets = datasets
        self._controller: TrainController | None = None

    def fit(self) -> Result:
        self._check_gpus()
        controller = TrainController(
            train_fn=self._train_fn,
            train_loop_config=self._config,
            scaling_config=self._scaling,
            run_config=self._run_config,
            datasets=self._datasets,
        )
        self._controller = controller
        return controller.run()


    def _check_gpus(self):
        """A worker that asks for a card on a cluster that counts none
        could never be placed: refuse now instead of waiting forever."""
        want = self._scaling.worker_resources().get("GPU", 0)
        if not want:
            return
        import ray_tpu_torch

        have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        if have < want:
            raise RuntimeError(
                f"ScalingConfig(use_gpu=True) asks for {want} GPU per worker "
                f"but the cluster counts {have}; pass use_gpu=False to "
                f"train on the CPU")


# Alias for API parity with the reference's generic trainer name.
DataParallelTrainer = TorchTrainer

__all__ = [
    "TorchTrainer",
    "DataParallelTrainer",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "Checkpoint",
    "Result",
    "TrainController",
    "report",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
]

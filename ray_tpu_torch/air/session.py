"""air.session — the unified in-trainer session surface.

Parity target: reference python/ray/air/session.py (report, get_checkpoint,
get_dataset_shard, get_world_rank/size — thin delegation to whichever
session is active: a train worker session or a tune trial session).

Counterpart: ray_tpu/air/session.py (copied).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


def _train_session():
    from ray_tpu_torch.train._internal.session import _session

    return _session


def _tune_session():
    from ray_tpu_torch.tune import _session as tune_session

    return tune_session._session


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None):
    s = _train_session()
    if s is not None:
        return s.report(metrics, checkpoint)
    t = _tune_session()
    if t is not None:
        return t.report(metrics, checkpoint)
    raise RuntimeError("air.session.report() outside a train/tune session")


def get_checkpoint() -> Optional[Checkpoint]:
    s = _train_session()
    if s is not None:
        return s.get_checkpoint()
    t = _tune_session()
    if t is not None:
        return t.get_checkpoint()
    return None


def get_dataset_shard(name: str = "train"):
    s = _train_session()
    if s is None:
        raise RuntimeError("no train session")
    return s.get_dataset_shard(name)


def get_world_rank() -> int:
    s = _train_session()
    return 0 if s is None else s.rank


def get_world_size() -> int:
    s = _train_session()
    return 1 if s is None else s.world_size


def get_local_rank() -> int:
    s = _train_session()
    return 0 if s is None else s.local_rank

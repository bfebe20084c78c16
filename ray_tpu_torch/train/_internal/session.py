"""Per-worker train session.

Parity target: reference python/ray/train/_internal/session.py
(_TrainSession:112, report:672, get_checkpoint:786, get_dataset_shard:1114).
The session is the worker-side half of the trainer: it knows this worker's
rank/world, buffers report() payloads for the controller to drain, persists
checkpoints into run storage THROUGH the storage plane
(`ray_tpu_torch/storage/`, README "Checkpointing & storage"), and hands out
dataset shards.

Checkpoint flow: `report(checkpoint=...)` accepts either a directory
`Checkpoint` (rank 0 uploads it) or a state pytree (EVERY rank saves its
local shards via the async engine; rank 0 commits the manifest). With
RT_CKPT_ASYNC=1 (default) the upload runs off the training step on the
engine's writer thread, and the report entry is released to the controller
only when the checkpoint COMMITS — the controller can never restart a
failed run from a checkpoint that wasn't durable yet.

Counterpart: ray_tpu/train/_internal/session.py (copied).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from ray_tpu_torch import storage
from ray_tpu_torch._private import watchdog
from ray_tpu_torch.train import checkpoint as ckpt_mod
from ray_tpu_torch.train.checkpoint import Checkpoint

logger = logging.getLogger(__name__)

_session: Optional["TrainSession"] = None
_session_lock = threading.Lock()


class TrainContext:
    """What user code sees via ray_tpu_torch.train.get_context() (reference
    train/context.py TrainContext)."""

    def __init__(self, session: "TrainSession"):
        self._s = session

    def get_world_rank(self) -> int:
        return self._s.rank

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_node_rank(self) -> int:
        return self._s.node_rank

    def get_trial_name(self) -> str:
        return self._s.run_name

    def get_experiment_name(self) -> str:
        return self._s.run_name

    def get_storage(self) -> str:
        return self._s.storage_dir


class TrainSession:
    def __init__(self, *, rank: int, world_size: int, local_rank: int,
                 node_rank: int, run_name: str, storage_dir: str,
                 restart_index: int, latest_checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[dict] = None, group_name: str = "default"):
        self.group_name = group_name
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.run_name = run_name
        self.storage_dir = storage_dir
        self.restart_index = restart_index
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.reports: list[dict] = []  # drained by the controller
        self.reports_lock = threading.Lock()
        self.report_seq = 0
        self.finished = False
        # (SaveHandle, entry) awaiting commit; guarded by _saves_lock (the
        # train loop reports while the controller's poll thread drains).
        self._pending_saves: list = []
        self._saves_lock = threading.Lock()
        # Serializes queue drains (and the direct-append fast path) so two
        # threads can never interleave released entries out of order.
        self._reap_lock = threading.Lock()

    # ------------------------------------------------------------- user API
    def report(self, metrics: dict, checkpoint=None):
        """reference session.py:672 — metrics to the controller; checkpoint
        persisted rank-aware through the storage backend. `checkpoint` is a
        directory Checkpoint (rank 0 owns the canonical copy) or a state
        pytree (sharded save: every rank writes its local shards)."""
        # Every report IS progress: tick this worker's stall beacon so a
        # healthy-but-slow step never trips the per-task watchdog while a
        # loop that stops calling report() eventually does.
        watchdog.report_progress()
        entry: dict[str, Any] = {"metrics": dict(metrics), "rank": self.rank}
        if checkpoint is None:
            # Queue behind any in-flight saves (handle=None releases as
            # soon as it reaches the front) — reports must reach the
            # controller in the order the loop made them, or the run's
            # FINAL metrics could be an older step's. The reap lock keeps
            # the emptiness check atomic with any in-progress drain.
            with self._reap_lock:
                with self._saves_lock:
                    if self._pending_saves:
                        self._pending_saves.append((None, entry))
                        return
                self._append(entry)
            return
        self.report_seq += 1
        # Namespaced by restart attempt: a resumed run must never write
        # onto an earlier attempt's checkpoint dirs.
        dest = storage.join(
            self.storage_dir, "checkpoints",
            f"checkpoint_r{self.restart_index}_{self.report_seq:06d}")
        if isinstance(checkpoint, Checkpoint):
            if self.rank != 0:
                self._append(entry)
                return
            # as_directory: a local dir passes through; a URI checkpoint
            # materializes first. Contents are buffered before the
            # context exits, so temp sources may vanish right after.
            with checkpoint.as_directory() as src:
                handle = ckpt_mod.upload_directory_async(
                    src, dest, step=self.report_seq)
        else:
            handle = ckpt_mod.save_async(
                checkpoint, dest, step=self.report_seq, rank=self.rank,
                world_size=self.world_size)
        if self.rank == 0:
            entry["checkpoint_path"] = dest
        if handle.done():
            # Sync mode (RT_CKPT_ASYNC=0): committed before report returns.
            handle.result()  # surface save failures to the train loop
            self._append(entry)
        else:
            # Async: hold the WHOLE entry until the save commits, then
            # release it — the controller only ever sees durable
            # checkpoints, and entries stay in report order (the engine
            # writer is single-threaded FIFO).
            with self._saves_lock:
                self._pending_saves.append((handle, entry))
            self._reap_pending(block=False)

    def _append(self, entry: dict):
        with self.reports_lock:
            self.reports.append(entry)

    def _reap_pending(self, block: bool, timeout: Optional[float] = None):
        """Release queued entries in strict FIFO order: drain the prefix
        whose saves committed (entries with no save release when reached);
        in blocking mode wait for all of them (end of the run / explicit
        flush). A failed save drops its checkpoint_path (metrics still
        flow) — the controller keeps restoring from the previous committed
        checkpoint."""
        with self._reap_lock:
            while True:
                with self._saves_lock:
                    if not self._pending_saves:
                        return
                    handle, entry = self._pending_saves[0]
                    if handle is not None and not block and not handle.done():
                        return
                    self._pending_saves.pop(0)
                if handle is not None:
                    try:
                        handle.result(timeout)
                    except Exception:
                        logger.exception(
                            "checkpoint save failed (rank %d, %s); reporting "
                            "metrics without it", self.rank, handle.uri)
                        entry.pop("checkpoint_path", None)
                self._append(entry)

    def flush_checkpoints(self, timeout: float = 300.0):
        """Wait for every in-flight async save to commit and release its
        report entry (called by the worker actor when the train loop
        returns — the controller's final drain must see the last
        checkpoint)."""
        self._reap_pending(block=True, timeout=timeout)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}; pass datasets= to the trainer")
        return shard

    def drain_reports(self) -> list[dict]:
        self._reap_pending(block=False)
        with self.reports_lock:
            out = self.reports
            self.reports = []
        return out


def init_session(**kw) -> TrainSession:
    global _session
    with _session_lock:
        _session = TrainSession(**kw)
    return _session


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No train session in this process — are you inside train_loop_per_worker?")
    return _session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None

"""Train controller: drives the worker group, drains reports, applies the
failure policy.

Parity target: reference train v2 controller
(train/v2/_internal/execution/controller/controller.py:91 TrainController,
run:446, loop :423) with FailurePolicy (failure_policy.py:14): on a
worker-group failure, if the policy allows, the whole group is torn down and
restarted from the latest reported checkpoint (elastic recovery).

Counterpart: ray_tpu/train/_internal/controller.py (copied).
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch import storage
from ray_tpu_torch.train import checkpoint as ckpt_mod
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import FailureConfig, RunConfig, ScalingConfig

logger = logging.getLogger(__name__)


class Result:
    """reference python/ray/air/result.py Result."""

    def __init__(self, metrics: Optional[dict], checkpoint: Optional[Checkpoint],
                 path: str, error: Optional[str] = None,
                 metrics_history: Optional[list] = None):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.path = path
        self.error = error
        self.metrics_history = metrics_history or []

    def __repr__(self):
        return (f"Result(metrics={self.metrics}, checkpoint={self.checkpoint}, "
                f"error={'yes' if self.error else None})")


class TrainController:
    def __init__(self, *, train_fn, train_loop_config,
                 scaling_config: ScalingConfig, run_config: RunConfig,
                 datasets: Optional[dict] = None):
        self.train_fn = train_fn
        self.config = train_loop_config
        self.scaling = scaling_config
        self.run_config = run_config
        self.datasets = datasets or {}
        self.run_name = run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        # storage_path may be any storage-plane URI (local path, local://,
        # mem://, sim://) — every durable byte below rides the backend.
        self.storage_dir = storage.join(run_config.resolved_storage(),
                                        self.run_name)
        storage.makedirs(self.storage_dir)
        self.latest_checkpoint: Optional[Checkpoint] = None
        self.metrics_history: list[dict] = []
        self._checkpoint_paths: list[str] = []
        self.failures = 0

    def _elastic_size(self) -> int:
        """Workers for the NEXT attempt (reference train v2 ScalingPolicy's
        elastic recovery decision): fixed groups always ask for num_workers;
        elastic groups (min_workers set) size to what the cluster can place
        right now, clamped to [min_workers, num_workers]."""
        want = self.scaling.num_workers
        lo = self.scaling.min_workers
        if lo is None or lo >= want:
            return want
        try:
            from ray_tpu_torch._private.rtconfig import CONFIG
            from ray_tpu_torch._private.worker import global_worker

            # Size against nodes that have beaten SINCE we started looking:
            # a node that died moments ago still shows alive (and its last
            # beat still looks recent) until the detection timeout, and
            # sizing against it would hang the restart on actors that can
            # never place. Waiting two beat intervals and requiring
            # beat_age < elapsed admits exactly the nodes with fresh
            # evidence of life — a ~1s pause instead of the previous
            # full-detection-window sleep (10s) on this thread.
            t0 = time.monotonic()
            time.sleep(CONFIG.heartbeat_interval_s * 2 + 0.2)
            elapsed = time.monotonic() - t0
            snap = global_worker().state_snapshot()
            avail: dict[str, float] = {}
            for n in snap["nodes"].values():
                if not n["alive"] or n.get("beat_age", 0.0) > elapsed:
                    continue
                for k, v in n["available"].items():
                    avail[k] = avail.get(k, 0.0) + v
        except Exception:
            return want
        per = self.scaling.worker_resources()
        fits = min((int(avail.get(k, 0.0) // v) for k, v in per.items() if v),
                   default=want)
        return max(1, lo, min(want, fits))

    def _split_datasets(self, n: int) -> Optional[list]:
        if not self.datasets:
            return None
        shards = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                for rank, piece in enumerate(ds.streaming_split(n)):
                    shards[rank][name] = piece
            else:
                for rank in range(n):
                    shards[rank][name] = ds
        return shards

    def run(self) -> Result:
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        while True:
            n_workers = (self.scaling.num_workers if attempt == 0
                         else self._elastic_size())
            if attempt > 0 and n_workers != self.scaling.num_workers:
                logger.warning("elastic restart with %d/%d workers",
                               n_workers, self.scaling.num_workers)
            try:
                group = WorkerGroup(
                    num_workers=n_workers,
                    resources_per_worker=self.scaling.worker_resources(),
                    run_name=self.run_name,
                    storage_dir=self.storage_dir,
                    group_name=f"train-{self.run_name}-r{attempt}",
                    restart_index=attempt,
                    latest_checkpoint=self.latest_checkpoint,
                    dataset_shards_per_worker=self._split_datasets(n_workers),
                    torch_distributed=self.scaling.torch_distributed,
                    worker_env=self.scaling.worker_env,
                )
            except Exception as e:
                # Group start failure goes through the same failure policy
                # as a mid-run crash (the group cleaned itself up).
                outcome = {"status": "system_failure", "error": f"group start failed: {e!r}"}
            else:
                try:
                    outcome = self._run_attempt(group)
                finally:
                    group.shutdown()
            if outcome["status"] == "finished":
                return Result(
                    metrics=self.metrics_history[-1] if self.metrics_history else None,
                    checkpoint=self.latest_checkpoint,
                    path=self.storage_dir,
                    metrics_history=self.metrics_history,
                )
            if outcome["status"] == "user_error":
                return Result(
                    metrics=self.metrics_history[-1] if self.metrics_history else None,
                    checkpoint=self.latest_checkpoint,
                    path=self.storage_dir,
                    error=outcome["error"],
                    metrics_history=self.metrics_history,
                )
            # system failure -> failure policy (reference failure_policy.py:14)
            self.failures += 1
            attempt += 1
            if max_failures != -1 and self.failures > max_failures:
                return Result(
                    metrics=self.metrics_history[-1] if self.metrics_history else None,
                    checkpoint=self.latest_checkpoint,
                    path=self.storage_dir,
                    error=f"training failed after {self.failures} failures: "
                          f"{outcome['error']}",
                    metrics_history=self.metrics_history,
                )
            logger.warning("train group failure %d (%s); restarting from %s",
                           self.failures, outcome["error"], self.latest_checkpoint)
            try:
                from ray_tpu_torch._private.events import emit_event

                emit_event(
                    "train_restart",
                    f"train group {self.run_name!r} failure "
                    f"{self.failures} ({str(outcome['error'])[:120]}); "
                    f"restarting from "
                    f"{getattr(self.latest_checkpoint, 'path', None)}",
                    entity=(self.run_name,),
                    attrs={"failures": self.failures, "attempt": attempt})
            except Exception:
                pass

    def _drain(self, group: WorkerGroup) -> int:
        """Drain worker reports into history; returns how many landed —
        the group-stall policy's definition of committed progress."""
        n = 0
        for p in group.poll():
            for rep in p["reports"]:
                n += 1
                self.metrics_history.append(rep["metrics"])
                if rep.get("checkpoint_path"):
                    self.latest_checkpoint = Checkpoint(rep["checkpoint_path"])
                    self._checkpoint_paths.append(rep["checkpoint_path"])
                    self._prune_checkpoints()
        return n

    def _prune_checkpoints(self):
        keep = self.run_config.checkpoint_config.num_to_keep
        if not keep:
            return
        while len(self._checkpoint_paths) > keep:
            victim = self._checkpoint_paths[0]
            if self.latest_checkpoint and victim == self.latest_checkpoint.path:
                self._checkpoint_paths.pop(0)
                continue
            # Backend delete, pin-aware: a checkpoint some other consumer
            # pinned (e.g. a Tune PBT clone restoring from this run)
            # survives until its last owner unpins — it stays TRACKED so a
            # later prune pass (the next report) retries the delete.
            try:
                if not ckpt_mod.delete_checkpoint(victim):
                    break  # oldest victim is pinned; retry next prune
            except Exception:
                logger.exception("checkpoint prune failed for %s", victim)
            self._checkpoint_paths.pop(0)

    def _report_group_stall(self, silent_s: float, stall_timeout: float):
        """Surface the group stall through the cluster's stall plane
        (util.state.list_stalls / rt_stalls_total) before the kill."""
        try:
            from ray_tpu_torch._private.worker import global_worker

            w = global_worker()
            if w is None:
                return
            w.controller.push_threadsafe("stall_report", report={
                "scope": "train_group", "stage": "kill",
                "task_id": None, "name": self.run_name, "attempt": None,
                "kind": "train", "worker_id": None, "node_id": None,
                "pid": os.getpid(), "silence_s": round(silent_s, 3),
                "time": time.time(),
                "reason": (f"train group {self.run_name!r} committed no "
                           f"progress for {silent_s:.1f}s (stall_timeout_s="
                           f"{stall_timeout}); killing the group and "
                           f"restarting from the latest committed "
                           f"checkpoint"),
                "events": [], "flight_dir": None,
            })
        except Exception:
            pass

    def _run_attempt(self, group: WorkerGroup) -> dict:
        stall_timeout = self.run_config.failure_config.stall_timeout_s
        run_refs = group.run_async(self.train_fn, self.config)
        pending = list(run_refs)
        last_progress = time.monotonic()
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=len(pending), timeout=0.2)
            if self._drain(group):
                last_progress = time.monotonic()
            if stall_timeout and not done:
                silent = time.monotonic() - last_progress
                if silent > stall_timeout:
                    # Silent hang: workers alive, sockets open, nothing
                    # reporting. Treat as a group failure — the caller
                    # tears the group down and the failure policy restarts
                    # from the latest COMMITTED checkpoint (the session
                    # releases report entries only on commit, so the
                    # restore point is always durable).
                    self._report_group_stall(silent, stall_timeout)
                    return {"status": "system_failure",
                            "error": f"train group stalled: no worker "
                                     f"reported progress for {silent:.1f}s "
                                     f"(stall_timeout_s={stall_timeout})"}
            for ref in done:
                try:
                    out = ray_tpu_torch.get(ref, timeout=30)
                except Exception as e:  # actor/worker/system death
                    self._drain(group)
                    return {"status": "system_failure", "error": repr(e)}
                if not out["ok"]:
                    self._drain(group)
                    return {"status": "user_error", "error": out["error"]}
                last_progress = time.monotonic()
        self._drain(group)
        return {"status": "finished"}

"""Worker group: the actor fleet a trainer runs on.

Parity target: reference python/ray/train/_internal/worker_group.py
(WorkerGroup:102, start:193, execute_async:233) + the v2 worker group
(train/v2/_internal/execution/worker_group/worker_group.py:103).

Counterpart: ray_tpu/train/_internal/worker_group.py (copied).
"""

from __future__ import annotations

import traceback
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch import storage
from ray_tpu_torch.train._internal import session as session_mod


@ray_tpu_torch.remote
class TrainWorkerActor:
    """Hosts one training worker. max_concurrency=2 in practice (set via
    .options at creation) so the controller can poll reports while the
    user's train loop occupies the other thread."""

    def __init__(self):
        self._error: Optional[str] = None

    def setup(self, *, rank: int, world_size: int, local_rank: int, node_rank: int,
              run_name: str, storage_dir: str, restart_index: int,
              latest_checkpoint, group_name: str, dataset_shards=None,
              torch_backend: Optional[str] = None):
        session_mod.init_session(
            rank=rank, world_size=world_size, local_rank=local_rank,
            node_rank=node_rank, run_name=run_name, storage_dir=storage_dir,
            restart_index=restart_index, latest_checkpoint=latest_checkpoint,
            dataset_shards=dataset_shards, group_name=group_name)
        # Host-tier collective rendezvous for DP gradient sync across
        # workers (role of reference _setup_torch_process_group,
        # train/torch/config.py:66; the torch process group itself is
        # opt-in through torch_distributed).
        from ray_tpu_torch.util import collective

        collective.init_collective_group(world_size, rank, group_name)
        if torch_backend:
            # One torch.distributed process group over every worker: rank 0
            # reserves the rendezvous port; the address rides the
            # controller KV (the reference's torch dist init_method).
            from ray_tpu_torch.train import torch_utils

            torch_utils.setup_torch_distributed(group_name, rank, world_size,
                                                backend=torch_backend)
        return True

    def run(self, train_fn, config):
        s = session_mod.get_session()
        try:
            # Accept 0- or 1-arg loops (reference train_loop_per_worker
            # signature inspection, data_parallel_trainer.py).
            import inspect

            takes_config = len(inspect.signature(train_fn).parameters) >= 1
            result = train_fn(config) if takes_config else train_fn()
            # Async checkpoint saves release their report entries on
            # commit: make every one durable+visible before the
            # controller's final drain.
            s.flush_checkpoints()
            s.finished = True
            return {"ok": True, "result": result}
        except BaseException:
            try:
                s.flush_checkpoints()
            except Exception:
                pass
            s.finished = True
            return {"ok": False, "error": traceback.format_exc()}

    def poll(self):
        s = session_mod.get_session()
        return {"reports": s.drain_reports(), "finished": s.finished}

    def shutdown(self):
        session_mod.shutdown_session()
        return True


class WorkerGroup:
    def __init__(self, *, num_workers: int, resources_per_worker: dict,
                 run_name: str, storage_dir: str, group_name: str,
                 restart_index: int = 0, latest_checkpoint=None,
                 dataset_shards_per_worker: Optional[list] = None,
                 torch_distributed: bool = False,
                 worker_env: Optional[dict] = None):
        self.num_workers = num_workers
        self.workers = []
        # NCCL for workers that hold a card, gloo on the CPU.
        torch_backend = None
        if torch_distributed:
            torch_backend = ("nccl" if resources_per_worker.get("GPU")
                             else "gloo")
        res = dict(resources_per_worker)
        opts = {"num_cpus": res.pop("CPU", 0), "max_concurrency": 4}
        if res.pop("GPU", 0):
            opts["num_gpus"] = resources_per_worker["GPU"]
        if res:
            opts["resources"] = res
        env_vars = dict(worker_env or {})
        # Stall-watchdog escalation dumps from these workers land under the
        # RUN's storage (<run>/flight/), not the node's session dir — they
        # must survive the worker AND travel with the run's artifacts. Only
        # injected while the escalation ladder is actually armed (the
        # resolved config propagates cluster-wide), so a default run's
        # worker env stays untouched.
        from ray_tpu_torch._private import watchdog

        if watchdog.enabled():
            env_vars.setdefault("RT_STALL_FLIGHT_DIR",
                                storage.join(storage_dir, "flight"))
        if env_vars:
            # Applied at worker-process spawn, BEFORE any import runs there
            # (CUDA_VISIBLE_DEVICES etc. must precede the first torch
            # import and CUDA's initialisation).
            opts["runtime_env"] = {"env_vars": env_vars}
        try:
            for rank in range(num_workers):
                self.workers.append(TrainWorkerActor.options(**opts).remote())
            setup_refs = []
            for rank, w in enumerate(self.workers):
                shards = (dataset_shards_per_worker[rank]
                          if dataset_shards_per_worker else None)
                setup_refs.append(w.setup.remote(
                    rank=rank, world_size=num_workers, local_rank=rank,
                    node_rank=0, run_name=run_name, storage_dir=storage_dir,
                    restart_index=restart_index, latest_checkpoint=latest_checkpoint,
                    group_name=group_name, dataset_shards=shards,
                    torch_backend=torch_backend))
            ray_tpu_torch.get(setup_refs, timeout=300)
        except BaseException:
            # A failed start must not strand the actors it already created.
            self.shutdown()
            raise

    def run_async(self, train_fn, config) -> list:
        return [w.run.remote(train_fn, config) for w in self.workers]

    def poll(self) -> list[dict]:
        """Poll every worker in ONE batched `ray_tpu_torch.get(refs)` (the old
        per-ref loop gathered serially: worker k's result waited on k-1
        slow pollers even when already resolved). Worker-returned arrays
        (checkpoint shards, eval tensors) ride device refs automatically
        when the plane is on — poll reports themselves are small dicts.
        Failure isolation is preserved: if the batch raises, fall back to
        per-ref gets so a dead worker loses only ITS reports."""
        refs = [w.poll.remote() for w in self.workers]
        try:
            return list(ray_tpu_torch.get(refs, timeout=60))
        except Exception:
            out = []
            for ref in refs:
                try:
                    out.append(ray_tpu_torch.get(ref, timeout=60))
                except Exception:
                    pass
            return out

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []

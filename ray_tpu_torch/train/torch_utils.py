"""Torch helpers for training workers.

Across workers, gradients and metrics ride the session's host-tier
collective group (`util.collective`, a ring over the runtime's rpc): the
role DDP's allreduce plays in the reference. `setup_torch_distributed`
joins the workers into one `torch.distributed` process group for loops
that drive collectives on the card themselves.

Counterpart: ray_tpu/train/jax_utils.py (ported: tensors or pytrees of them
in and out; `setup_torch_distributed` replaces `setup_jax_distributed`).
"""

from __future__ import annotations

import numpy as np
from torch.utils import _pytree

from ray_tpu_torch.util import collective


def _resolve_group(group_name):
    """None -> the train session's own collective group."""
    if group_name is not None:
        return group_name
    from ray_tpu_torch.train._internal.session import get_session

    return get_session().group_name


def sync_gradients(grads, group_name: str | None = None, average: bool = True):
    """Cross-worker gradient allreduce of a tensor or pytree of tensors
    (host tier). Plays the role of DDP's allreduce (reference
    train/torch/config.py DDP wrap): each leaf comes back as a tensor of
    its dtype on its device, averaged over the world unless
    `average=False`. group_name=None uses the train session's group."""
    group_name = _resolve_group(group_name)
    summed = collective.allreduce(grads, group_name=group_name)
    world = collective.get_collective_group_size(group_name)
    if average and world > 1:
        summed = _pytree.tree_map(lambda g: g / world, summed)
    return summed


def sync_metric(value: float, group_name: str | None = None) -> float:
    group_name = _resolve_group(group_name)
    out = collective.allreduce(np.asarray([value], dtype=np.float64),
                               group_name=group_name)
    return float(out[0]) / collective.get_collective_group_size(group_name)


def broadcast_params(params, group_name: str | None = None, src_rank: int = 0):
    """Make rank 0's initial parameters authoritative across the group."""
    group_name = _resolve_group(group_name)
    return collective.broadcast(params, src_rank=src_rank,
                                group_name=group_name)


def setup_torch_distributed(group_name: str, rank: int, world_size: int,
                            backend: str = "gloo", timeout_s: float = 60.0):
    """Join all train workers into ONE torch.distributed process group:
    rank 0 reserves a port and publishes host:port through the controller
    KV; every rank then calls `init_process_group` on it (reference role:
    torch.distributed init_method rendezvous). `backend` is "nccl" for
    workers that hold a card, "gloo" on the CPU."""
    import datetime
    import socket
    import time

    import torch.distributed as dist

    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    key = f"torchdist/{group_name}/coordinator"
    if rank == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()  # race-prone in theory; the store rebinds immediately
        # Workers bind loopback in this runtime; on a real multi-host
        # deployment the node agent's host IP takes this seat.
        host = w.server_addr[0] if w.server_addr else "127.0.0.1"
        addr = f"{host}:{port}"
        w.kv("put", ns="train", key=key, value=addr.encode())
    else:
        deadline = time.monotonic() + timeout_s
        addr = None
        while time.monotonic() < deadline:
            v = w.kv("get", ns="train", key=key)["value"]
            if v is not None:
                addr = bytes(v).decode()
                break
            time.sleep(0.05)
        if addr is None:
            raise TimeoutError("torch.distributed rendezvous timed out")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return addr

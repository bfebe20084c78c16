"""The port's multi-rank dryrun: every sharded path of the parallelism
layer run once and held against its unsharded twin.

Counterpart: `dryrun_multichip` of the JAX package's `__graft_entry__.py`,
with the same configurations chosen by rank count. Where the reference
builds an n-device mesh in one process, here n rank processes are spawned
(`run_ranks`): they meet through a `file://` rendezvous in a fresh
directory (no fixed ports), form one gloo process group, and each runs the
checks on its shards; rank 0 prints one line per check.

    python -m ray_tpu_torch.parallel.dryrun 4 [cuda|cpu] [gloo|nccl]

The device defaults to "cuda" (a rank raises without a card); pass "cpu"
for the plain PyTorch paths. On "cuda" rank r computes on card r mod the
cards visible. With one card every rank shares it and the collectives go
through host memory (gloo): the sharded math runs through the port's
kernels at the per-rank shapes, but nothing here measures multi-GPU
scaling. With a card per rank, "nccl" moves CUDA tensors directly (and
refuses ranks that share a card).

The models are the reference's, at its widths: the training step's 8
heads of 16 at d_model 128 and generation's d_model 64 in 4 heads
(TRAIN_CONFIG, GENERATE_CONFIG). On "cuda" the flash kernels run the
training step and the decode kernel the generation at head dim 16;
`dryrun_ranks` also returns each rank's launches by kernel and head dim.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                         data_sharding, shard_tensor)


#: The sharded training step's model: __graft_entry__.py's run_sharded_step
#: (d_model 128 in 8 heads, so head dim 16; f32 for exactness).
TRAIN_CONFIG = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=8,
                    n_kv_heads=8, d_ff=344, max_seq=64)
#: The tp generate's model: __graft_entry__.py's run_tp_generate (d_model
#: 64 in 4 heads, so head dim 16).
GENERATE_CONFIG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                       max_seq=64)


def _rank_main(rank, world_size, store, out_dir, backend, fn, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=600))
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend: str = "gloo") -> list:
    """Run fn(rank, *args) in `world_size` spawned processes joined into one
    process group of `backend`; returns each rank's result, in rank order.
    `fn` must be importable by name (a module-level function). A rank that
    raises fails the call."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="rt_ranks_")
    try:
        mp.start_processes(
            _rank_main,
            args=(world_size, os.path.join(tmp, "store"), tmp, backend, fn,
                  args),
            nprocs=world_size, join=True, start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _say(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def run_sharded_step(rank: int, mcfg: MeshConfig, label: str,
                     moe_experts: int = 0, device="cuda") -> float:
    """Loss, gradients and one Adam step of the flagship model on sharded
    parameters and optimizer state; the loss must equal the unsharded
    step's within the reference's 1e-3 (f32)."""
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn)

    device = resolve_device(device)
    mesh = build_mesh(mcfg)
    cfg = TransformerConfig(**TRAIN_CONFIG, dtype=torch.float32,
                            moe_experts=moe_experts)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 33))).to(device)

    model = Transformer(cfg, device=device, seed=0, mesh=mesh)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = loss_fn(model, shard_tensor(tokens, data_sharding(mesh), mesh))
    loss.backward()
    opt.step()
    loss = loss.item()

    ref = Transformer(cfg, device=device, seed=0)
    ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-3)
    ref_loss = loss_fn(ref, tokens)
    ref_loss.backward()
    ref_opt.step()
    ref_loss = ref_loss.item()
    if not (np.isfinite(loss) and abs(loss - ref_loss) < 1e-3):
        raise AssertionError(
            f"[{label}] sharded loss {loss} != single-device {ref_loss}")
    _say(rank, f"dryrun[{label}]: mesh={mesh.shape} loss={loss:.4f} "
               f"ref={ref_loss:.4f} transport={mesh.backend} OK")
    return loss


def run_pipeline_step(rank: int, n_stages: int, label: str,
                      device="cuda") -> float:
    """GPipe over pp (parallel/pipeline.py): loss, gradients and an Adam
    step through the microbatched schedule, within 1e-4 of the
    sequential loss."""
    from ray_tpu_torch.parallel.pipeline import (PipelineConfig, init_params,
                                                 pipeline_loss_fn,
                                                 reference_loss, stage_params)

    device = resolve_device(device)
    mesh = build_mesh(MeshConfig(dp=-1, pp=n_stages))
    cfg = PipelineConfig(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
                         d_ff=128, n_microbatches=4)
    full = init_params(cfg, device=device)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 17))).to(device)
    params = stage_params(full, mesh)
    leaves = [params["emb"], params["final_norm"], *params["blocks"].values()]
    for p in leaves:
        p.requires_grad_()
    opt = torch.optim.Adam(leaves, lr=1e-3)
    loss = pipeline_loss_fn(cfg, mesh)(params, tokens)
    loss.backward()
    opt.step()
    loss = loss.item()
    with torch.no_grad():
        ref = reference_loss(cfg, full, tokens).item()
    if not (np.isfinite(loss) and abs(loss - ref) < 1e-4):
        raise AssertionError(
            f"[{label}] pipeline loss {loss} != sequential {ref}")
    _say(rank, f"dryrun[{label}]: mesh={mesh.shape} microbatches="
               f"{cfg.n_microbatches} loss={loss:.4f} ref={ref:.4f} "
               f"transport={mesh.backend} OK")
    return loss


def run_tp_generate(rank: int, tp: int, label: str, device="cuda"):
    """The continuous-batching engine over a tp mesh: its greedy tokens
    must equal the unsharded engine's."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams

    cfg = LLMConfig(**GENERATE_CONFIG)
    mesh = build_mesh(MeshConfig(dp=-1, tp=tp))
    eng = ContinuousEngine(cfg, max_batch=2, decode_chunk=4, mesh=mesh,
                           device=device)
    if rank != 0:
        eng.follow()
        return None
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    try:
        out = eng.submit([1, 2, 3, 4], sp).tokens()
    finally:
        eng.shutdown()
    ref_eng = ContinuousEngine(cfg, max_batch=2, decode_chunk=4, device=device)
    try:
        ref = ref_eng.submit([1, 2, 3, 4], sp).tokens()
    finally:
        ref_eng.shutdown()
    if not (len(out) == 8 and out == ref):
        raise AssertionError(
            f"[{label}] tp{tp} generate {out} != single-device {ref}")
    _say(rank, f"dryrun[{label}]: mesh={mesh.shape} tokens={out[:4]}... "
               f"transport={mesh.backend} OK")
    return out


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    """The reference's configurations for n ranks (every parallelism axis
    > 1 across them; dp=-1 absorbs the rest): {"runs": [(label, result)],
    "launches": this rank's kernel launches by name and head dim}."""
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kernels.reset_launch_counts()
    runs = []
    if n % 4 == 0:
        fsdp = MeshConfig(dp=-1, fsdp=2, tp=2)
        moe = MeshConfig(dp=-1, fsdp=2, ep=2) if n % 8 == 0 \
            else MeshConfig(dp=-1, ep=2)
        runs += [(run_sharded_step, MeshConfig(dp=-1, sp=2, tp=2),
                  "dp.sp2.tp2", 0),
                 (run_sharded_step, fsdp,
                  "fsdp2.tp2.dp" if n % 8 == 0 else "fsdp2.tp2", 0),
                 (run_sharded_step, moe, "ep2.moe", 4),
                 (run_pipeline_step, 2, "pp2.pipeline"),
                 (run_tp_generate, 4, "tp4.llm.generate")]
    elif n % 2 == 0:
        runs += [(run_sharded_step, MeshConfig(dp=-1, tp=2), "dp.tp2", 0),
                 (run_pipeline_step, 2, "pp2.pipeline"),
                 (run_tp_generate, 2, "tp2.llm.generate")]
    else:
        runs += [(run_sharded_step, MeshConfig(dp=n), "dp", 0)]
    out = []
    for fn, *args in runs:
        if fn is run_sharded_step:
            mcfg, label, experts = args
            out.append((label, fn(rank, mcfg, label, experts, device)))
        else:
            arg, label = args
            out.append((label, fn(rank, arg, label, device)))
    _say(rank, f"dryrun_multichip({n}) OK")
    return {"runs": out, "launches": kernels.launch_counts_by_head_dim()}


def dryrun_ranks(n_devices: int, device: str = "cuda",
                 backend: str = "gloo") -> list[dict]:
    """Spawn n_devices ranks of `backend` and run every sharded path of
    the port's parallelism layer; raises on the first that disagrees.
    Returns each rank's {"runs", "launches"} (see `_dryrun_rank`)."""
    return run_ranks(_dryrun_rank, n_devices, n_devices, device,
                     backend=backend)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "gloo") -> list:
    """`dryrun_ranks`, returning rank 0's (label, result) list."""
    return dryrun_ranks(n_devices, device, backend)[0]["runs"]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     *sys.argv[2:4])

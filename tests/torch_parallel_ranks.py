"""Rank-side halves of tests/test_torch_sp.py and tests/test_torch_parallel.py.

Each public function here runs in one rank process spawned by
`ray_tpu_torch.parallel.dryrun.run_ranks` (gloo over a `file://`
rendezvous, CPU tensors). It imports torch and the port only, so the ranks
start without JAX; the test modules compute the JAX package's side in the
test process and compare. Inputs arrive as numpy arrays, results go back as
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import (Mesh, MeshConfig, build_mesh,
                                         data_sharding, shard_params,
                                         shard_tensor)

# ------------------------------------------------------------ collectives
#: name -> (mesh axes, torch function of (x, mesh), input sharded?)
COLLECTIVES = {
    "psum": ({"i": 4}, lambda x, m: col.psum(x, "i", m), True),
    "pmean": ({"i": 4}, lambda x, m: col.pmean(x, "i", m), True),
    "pvary": ({"i": 4}, lambda x, m: col.pvary(x, "i", m), False),
    "all_gather": ({"i": 4}, lambda x, m: col.all_gather(x, "i", m), True),
    "all_gather_dim1": ({"i": 4},
                        lambda x, m: col.all_gather(x, "i", m, dim=1), True),
    "all_gather_untiled": ({"i": 4}, lambda x, m: col.all_gather(
        x, "i", m, dim=0, tiled=False), True),
    "all_gather_invariant": ({"i": 4}, lambda x, m: col.all_gather_invariant(
        x, "i", m), True),
    "psum_scatter": ({"i": 4}, lambda x, m: col.psum_scatter(x, "i", m),
                     True),
    "ppermute_ring": ({"i": 4}, lambda x, m: col.ppermute_ring(x, "i", m),
                      True),
    "ppermute_line": ({"i": 4}, lambda x, m: col.ppermute(
        x, "i", m, [(0, 1), (1, 2), (2, 3)]), True),
    "all_to_all": ({"i": 4}, lambda x, m: col.all_to_all(x, "i", m, 1, 0),
                   True),
    "psum_tuple": ({"a": 2, "b": 2},
                   lambda x, m: col.psum(x, ("a", "b"), m), True),
    "all_gather_tuple": ({"a": 2, "b": 2},
                         lambda x, m: col.all_gather(x, ("a", "b"), m), True),
    "psum_scatter_tuple": ({"a": 2, "b": 2},
                           lambda x, m: col.psum_scatter(x, ("a", "b"), m),
                           True),
    "all_gather_tuple_reversed": ({"a": 2, "b": 2}, lambda x, m:
                                  col.all_gather(x, ("b", "a"), m), True),
    "psum_scatter_tuple_reversed": ({"a": 2, "b": 2}, lambda x, m:
                                    col.psum_scatter(x, ("b", "a"), m), True),
}
#: name -> the block of a sharded tensor each rank holds, where that is
#: not the rank's own index (a spec naming (b, a) on an (a, b) mesh)
BLOCK_OF_RANK = {"all_gather_tuple_reversed": (0, 2, 1, 3),
                 "psum_scatter_tuple_reversed": (0, 2, 1, 3)}


def block_of_rank(name: str, rank: int) -> int:
    return BLOCK_OF_RANK.get(name, range(4))[rank]


def collectives(rank: int, inputs: dict) -> dict:
    """For each case: this rank's output and the gradient of
    sum(output * cotangent) with respect to this rank's input block.
    inputs[name] = (global x, this case's cotangents per rank)."""
    meshes = {}
    out = {}
    for name, (axes, fn, sharded) in COLLECTIVES.items():
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = Mesh(axes)
        mesh = meshes[key]
        x_global, cts = inputs[name]
        x = torch.from_numpy(x_global)
        if sharded:
            x = x.chunk(4)[block_of_rank(name, rank)]
        x = x.clone().requires_grad_()
        y = fn(x, mesh)
        (y * torch.from_numpy(cts[rank])).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    mesh = Mesh({"i": 4})
    x = torch.from_numpy(inputs["mesh_allreduce"]).chunk(4)[rank]
    out["mesh_allreduce"] = col.mesh_allreduce(mesh, x, "i").numpy()
    return out


# ------------------------------------------------ sequence parallelism
def sequence_parallel(rank: int, cases: dict) -> dict:
    """Ring and Ulysses attention over sp=4: this rank's output block per
    case (q, k, v global [B, S, H, D] numpy; sequence-sharded here)."""
    from ray_tpu_torch.ops import ring_attention, ulysses_attention

    mesh = Mesh({"sp": 4})
    out = {}
    for name, (kind, causal, q, k, v) in cases.items():
        q, k, v = (torch.from_numpy(t).chunk(4, dim=1)[rank] for t in (q, k, v))
        fn = ring_attention if kind == "ring" else ulysses_attention
        out[name] = fn(q, k, v, axis_name="sp", mesh=mesh,
                       causal=causal).numpy()
    return out


def pipeline(rank: int, cfg_kwargs: dict, tokens: np.ndarray) -> dict:
    """GPipe over pp=2 (dp=2 replicas): the loss and the gradients of this
    rank's stage parameters."""
    from ray_tpu_torch.parallel.pipeline import (PipelineConfig, init_params,
                                                 pipeline_loss_fn,
                                                 stage_params)

    cfg = PipelineConfig(**cfg_kwargs)
    mesh = build_mesh(MeshConfig(dp=-1, pp=2))
    params = stage_params(init_params(cfg, device="cpu"), mesh)
    leaves = {"emb": params["emb"], "final_norm": params["final_norm"],
              **{f"blocks/{k}": v for k, v in params["blocks"].items()}}
    for p in leaves.values():
        p.requires_grad_()
    loss = pipeline_loss_fn(cfg, mesh)(params, torch.from_numpy(tokens))
    loss.backward()
    return {"stage": mesh.index("pp"), "loss": loss.item(),
            "grads": {k: p.grad.numpy() for k, p in leaves.items()}}


def sp_checks(rank, inputs, sp_cases, pipe_kwargs, tokens) -> dict:
    """Every rank-side check of tests/test_torch_sp.py, in one spawn."""
    return {"coll": collectives(rank, inputs),
            "sp": sequence_parallel(rank, sp_cases),
            "pipe": pipeline(rank, pipe_kwargs, tokens)}


# ------------------------------------------------- sharded Transformer
def sharded_transformer(rank: int, runs: dict) -> dict:
    """For each run (mesh sizes, TransformerConfig kwargs, the full
    state_dict, tokens): the loss and every parameter's gradient box with
    its [start, stop) per dimension."""
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn,
                                                  param_specs)

    out = {}
    for name, (mcfg, cfg_kwargs, state, tokens) in runs.items():
        mesh = build_mesh(MeshConfig(**mcfg))
        cfg = TransformerConfig(**cfg_kwargs, dtype=torch.float32)
        model = Transformer(cfg, device="cpu", mesh=mesh)
        full = {k: torch.from_numpy(v) for k, v in state.items()}
        specs = param_specs(full)
        model.load_state_dict(shard_params(full, specs, mesh))
        toks = shard_tensor(torch.from_numpy(tokens), data_sharding(mesh),
                            mesh)
        loss = loss_fn(model, toks)
        loss.backward()
        out[name] = {"loss": loss.item(), "grads": {
            n: (mesh.local_box(full[n].shape, specs[n]), p.grad.numpy())
            for n, p in model.named_parameters()}}
    return out


def tp_engine(rank: int, llm_kwargs: dict, flax_params: dict,
              prompts: list, max_tokens: int) -> list | None:
    """The engine over tp=2 (dp=2 replicas following rank 0): rank 0's
    greedy tokens for each prompt."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams

    cfg = LLMConfig(**llm_kwargs, params=flax_params)
    mesh = build_mesh(MeshConfig(dp=-1, tp=2))
    eng = ContinuousEngine(cfg, max_batch=2, decode_chunk=4, mesh=mesh,
                           device="cpu")
    if rank != 0:
        eng.follow()
        return None
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=max_tokens)
        return [s.tokens() for s in [eng.submit(p, sp) for p in prompts]]
    finally:
        eng.shutdown()


def sharded_restore(rank: int, dirs: dict, specs: dict) -> dict:
    """Each checkpoint of `dirs` restored onto a tp=2 mesh (dp=2), with
    `specs` given as a dict by path, as one spec and as a callable: this
    rank's block of every leaf."""
    from ray_tpu_torch.parallel.mesh import P
    from ray_tpu_torch.train import checkpoint as ck

    mesh = build_mesh(MeshConfig(dp=-1, tp=2))
    out = {"tp": mesh.index("tp")}
    for name, d in dirs.items():
        out[name, "dict"] = ck.restore(d, mesh=mesh, shardings=specs)
        out[name, "spec"] = ck.restore(d, mesh=mesh, shardings=P(None, "tp"))
        out[name, "callable"] = ck.restore(
            d, mesh=mesh, shardings=lambda path, shape, dtype: specs.get(path))
    return out


def parallel_checks(rank, runs, engine_args, restore_args) -> dict:
    """Every rank-side check of tests/test_torch_parallel.py, in one spawn."""
    return {"model": sharded_transformer(rank, runs),
            "engine": tp_engine(rank, *engine_args),
            "restore": sharded_restore(rank, *restore_args)}


def tp_train_loop(config):
    """A TorchTrainer loop (torch_distributed=True, 2 workers): one Adam
    step of a small Transformer over a tp=2 mesh of the workers' process
    group; reports the loss and this rank's box of wq's gradient."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn)
    from ray_tpu_torch.train.torch_utils import global_mesh_from_distributed

    mesh = global_mesh_from_distributed(("tp",))
    cfg = TransformerConfig(**config["cfg"], dtype=torch.float32)
    model = Transformer(cfg, device="cpu", seed=0, mesh=mesh)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = loss_fn(model, torch.from_numpy(config["tokens"]))
    loss.backward()
    opt.step()
    wq = model.layers[0].attn.wq
    train.report({"loss": loss.item(), "tp": mesh.index("tp"),
                  "backend": mesh.backend,
                  "wq_box": mesh.local_box(
                      (cfg.d_model, cfg.n_heads, cfg.head_dim),
                      ("fsdp", "tp", None)),
                  "wq_grad": wq.grad.numpy()})


# ------------------------------------------------------- on the card
def card_tp_forward(rank: int, cfg_kwargs: dict, tokens: np.ndarray) -> dict:
    """Two ranks sharing the card: the tp=2 forward's gathered logits, and
    on rank 0 the unsharded forward's (f32, TF32 off)."""
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.models.transformer import Transformer, TransformerConfig

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    mesh = build_mesh(MeshConfig(dp=-1, tp=2))
    toks = torch.from_numpy(tokens).cuda()
    before = kernels.FLASH_ATTENTION.launches
    with torch.no_grad():
        out = {"logits": Transformer(cfg, device="cuda", seed=0,
                                     mesh=mesh)(toks).cpu().numpy(),
               "flash_launches": kernels.FLASH_ATTENTION.launches - before,
               "transport": mesh.backend}
        if rank == 0:
            out["ref"] = Transformer(cfg, device="cuda",
                                     seed=0)(toks).cpu().numpy()
    return out


def nccl_on_one_card(rank: int) -> str:
    """The message build_mesh raises for nccl ranks that share a card."""
    torch.cuda.set_device(0)
    try:
        build_mesh(MeshConfig(dp=-1))
    except RuntimeError as e:
        return str(e)
    return ""

"""Pipeline parallelism: a GPipe microbatched schedule over the "pp" mesh
axis.

Counterpart: ray_tpu/parallel/pipeline.py. The block stack's parameters
carry a leading [n_layers] axis; each rank holds its stage's slice of it
(`stage_params`). Every pipeline tick applies the local stage to the
activation in flight and `ppermute`s it to the next stage; with M
microbatches and S stages the schedule runs M + S - 1 ticks and the bubble
is (S-1)/(M+S-1). The last stage's outputs reach every stage through a
psum over pp (zeros elsewhere), where the replicated head computes the
loss. The backward pipeline comes from autograd through the
differentiable ppermute, whose transpose is the reverse permutation, as
the reference gets it from JAX's transpose.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import _reference_attention
from ray_tpu_torch.parallel.collectives import ppermute, psum, pvary


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_layers: int = 4  # total, split evenly across pp stages
    n_heads: int = 4
    d_ff: int = 256
    n_microbatches: int = 4


def init_params(cfg: PipelineConfig, seed: int = 0, device="cuda") -> dict:
    """Parameters as a dict of f32 tensors on `device` (pass "cpu" for the
    plain PyTorch path); block weights stacked on a leading [n_layers] axis
    (the axis pp shards). The numpy draws are the reference's, so the
    values equal the JAX package's."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    L, D, F_, _H = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[0]))
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(device)

    return {
        "emb": w(cfg.vocab_size, D, scale=0.02),
        "blocks": {
            "wq": w(L, D, D), "wk": w(L, D, D), "wv": w(L, D, D),
            "wo": w(L, D, D),
            "w_gate": w(L, D, F_), "w_up": w(L, D, F_), "w_down": w(L, F_, D),
            "norm1": torch.ones((L, D), device=device),
            "norm2": torch.ones((L, D), device=device),
        },
        "final_norm": torch.ones((D,), device=device),
    }


def stage_params(params: dict, mesh) -> dict:
    """This rank's parameters: its stage's slice of every block weight,
    the embedding and final norm whole."""
    n = mesh.size("pp")
    i = mesh.index("pp")

    def cut(x):
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per].clone()

    return {"emb": params["emb"].clone(),
            "blocks": {k: cut(v) for k, v in params["blocks"].items()},
            "final_norm": params["final_norm"].clone()}


def _rms(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) * scale


def _block(bp, x, n_heads: int):
    """One transformer block with single-layer params bp (no leading axis)."""
    b, s, d = x.shape
    hd = d // n_heads
    h = _rms(x, bp["norm1"])
    q = (h @ bp["wq"]).reshape(b, s, n_heads, hd)
    k = (h @ bp["wk"]).reshape(b, s, n_heads, hd)
    v = (h @ bp["wv"]).reshape(b, s, n_heads, hd)
    att = _reference_attention(q, k, v, causal=True).reshape(b, s, d)
    x = x + att @ bp["wo"]
    h = _rms(x, bp["norm2"])
    return x + (F.silu(h @ bp["w_gate"]) * (h @ bp["w_up"])) @ bp["w_down"]


def _stage_apply(stage_blocks: dict, x, n_heads: int):
    """Apply the blocks of `stage_blocks` (leading axis) in order."""
    for layer in range(stage_blocks["wq"].shape[0]):
        x = _block({k: v[layer] for k, v in stage_blocks.items()}, x, n_heads)
    return x


def _head_loss(params, x, tokens):
    x = _rms(x, params["final_norm"])
    logits = x @ params["emb"].t()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def pipeline_loss_fn(cfg: PipelineConfig, mesh):
    """Returns loss(params, tokens), params this rank's `stage_params`,
    whose block stack runs as a GPipe pipeline over the mesh's pp axis
    (embedding and head replicated). The loss is equal on every rank."""
    n_stages = mesh.size("pp")
    stage = mesh.index("pp")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split over "
                         f"{n_stages} stages")
    perm_fwd = [(i, i + 1) for i in range(n_stages - 1)]

    def loss_fn(params, tokens):
        x = params["emb"][tokens[:, :-1]]  # [B, S, D]
        b, s, d = x.shape
        M = cfg.n_microbatches
        if b % M:
            raise ValueError(f"batch {b} does not split into {M} microbatches")
        # every stage embeds; stage 0 consumes it (its gradient is summed
        # over pp, zeros from the other stages)
        x_mb = pvary(x.reshape(M, b // M, s, d), "pp", mesh)
        buf = torch.zeros_like(x_mb[0])
        # Selections by stage are made with torch.where, not Python
        # branches: every rank then builds the same graph, so the backward
        # runs every collective's transpose on every rank, in one order.
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == n_stages - 1, device=x.device)
        ys = []
        for t in range(M + n_stages - 1):
            cur = torch.where(first, x_mb[min(t, M - 1)], buf)
            y = _stage_apply(params["blocks"], cur, cfg.n_heads)
            buf = ppermute(y, "pp", mesh, perm_fwd)
            ys.append(y)
        # On the last stage, ys[t] for t in [S-1, S-1+M) are microbatches
        # 0..M-1; the psum hands them to every stage.
        outs = torch.stack(ys[n_stages - 1:n_stages - 1 + M])
        outs = torch.where(last, outs, 0.0)
        y = psum(outs, "pp", mesh).reshape(b, s, d)
        return _head_loss(params, y, tokens)

    return loss_fn


def reference_loss(cfg: PipelineConfig, params, tokens):
    """Single-device sequential apply of the same stacked params."""
    x = params["emb"][tokens[:, :-1]]
    x = _stage_apply(params["blocks"], x, cfg.n_heads)
    return _head_loss(params, x, tokens)

"""Plain reference of the measured decoder: a llama-style transformer
(RMSNorm, rotary embeddings over split halves, causal multi-head or
grouped-query attention, SwiGLU, tied embedding and head) written in
PyTorch operations alone, in float32 with TF32 off.

It imports nothing of the port. Its weights come from its own frozen copy
of the recipe the port's `Transformer` draws its seeded weights by: one
CPU `torch.Generator` seeded with the model's seed, drawn in the order of
the parameters (embedding, then each layer's attention norm, wq, wk, wv,
wo, MLP norm, w_gate, w_up, w_down, then the final norm), normal(0.02)
for the embedding, lecun-normal for the kernels with flax's fan-in (the
input axis of wq/wk/wv [d, H, hd], every axis but the last of the
others), norm scales at one.

`Precision("fp8")` computes every product with both operands rounded to
float8 e4m3 at a per-tensor scale, forward and backward: the control that
must come out as not correct.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


def tf32_off() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass(frozen=True)
class Widths:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    rope_theta: float = 10000.0
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def layer_shapes(w: Widths) -> list:
    """(name, shape) of one layer's tensors, in the recipe's order; a norm
    scale has no draw."""
    d, h, kv, hd, ff = (w.d_model, w.n_heads, w.n_kv_heads, w.head_dim,
                        w.d_ff)
    return [("attn_norm.scale", (d,)), ("attn.wq", (d, h, hd)),
            ("attn.wk", (d, kv, hd)), ("attn.wv", (d, kv, hd)),
            ("attn.wo", (h, hd, d)), ("mlp_norm.scale", (d,)),
            ("mlp.w_gate", (d, ff)), ("mlp.w_up", (d, ff)),
            ("mlp.w_down", (ff, d))]


def _std(name: str, shape) -> float:
    if name == "tok_emb":
        return 0.02
    if name.endswith(("wq", "wk", "wv")):
        return shape[0] ** -0.5
    return math.prod(shape[:-1]) ** -0.5


class WeightStream:
    """The seeded weights, drawn on the host in the recipe's order: first
    `embedding()`, then `layer(i)` for i = 0, 1, ... in turn."""

    def __init__(self, w: Widths, seed: int):
        self.w = w
        self.gen = torch.Generator().manual_seed(seed)
        self.next_layer = 0

    def _draw(self, name: str, shape) -> torch.Tensor:
        if name.endswith("scale"):
            return torch.ones(shape, dtype=torch.float32)
        return torch.empty(shape, dtype=torch.float32).normal_(
            0.0, _std(name, shape), generator=self.gen)

    def embedding(self) -> torch.Tensor:
        return self._draw("tok_emb", (self.w.vocab_size, self.w.d_model))

    def layer(self, i: int) -> dict:
        if i != self.next_layer:
            raise ValueError(f"layer {i} drawn out of order "
                             f"(next is {self.next_layer})")
        self.next_layer += 1
        return {name: self._draw(name, shape)
                for name, shape in layer_shapes(self.w)}

    def all(self) -> dict:
        """Every tensor, named as the port's state_dict names them."""
        out = {"tok_emb": self.embedding()}
        for i in range(self.w.n_layers):
            out.update({f"layers.{i}.{k}": v
                        for k, v in self.layer(i).items()})
        out["final_norm.scale"] = torch.ones(self.w.d_model)
        return out


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to 448), back in float32."""
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """How the reference computes its products: "f32", or "fp8" for the
    control."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a, b):
        """a @ b for 2-D operands or operands with equal batch dims."""
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def linear(self, x, w2d):
        """x [..., k] @ w2d [k, n]."""
        out = self.mm(x.reshape(-1, x.shape[-1]), w2d)
        return out.reshape(*x.shape[:-1], w2d.shape[1])


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, positions, theta):
    """x [S, H, D], positions [S]: rotary embeddings over split halves."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = positions[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Precision, q_block: int | None = None):
    """Causal attention of one sequence: q [S, Hq, D], k, v [S, Hkv, D];
    key j is visible to query i when j <= i. `q_block` computes the rows
    in blocks (no autograd there) to bound the scores' memory."""
    s, hq, d = q.shape
    rep = hq // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [H, S, D]
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    step = q_block or s
    outs = []
    for a in range(0, s, step):
        b = min(s, a + step)
        scores = prec.mm(qh[:, a:b], kh[:, :b].transpose(1, 2)) / d ** 0.5
        rows = torch.arange(a, b, device=q.device)[:, None]
        cols = torch.arange(b, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        outs.append(prec.mm(torch.softmax(scores, dim=-1), vh[:, :b]))
    return torch.cat(outs, dim=1).transpose(0, 1)  # [S, H, D]


def block(x, p: dict, w: Widths, prec: Precision, q_block=None):
    """One decoder layer over x [S, d] of one sequence (positions 0..S-1);
    `p` holds its tensors under the names of `layer_shapes`."""
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    h = rmsnorm(x, p["attn_norm.scale"], w.eps)
    q = prec.linear(h, p["attn.wq"].reshape(w.d_model, -1)).reshape(
        s, w.n_heads, w.head_dim)
    k = prec.linear(h, p["attn.wk"].reshape(w.d_model, -1)).reshape(
        s, w.n_kv_heads, w.head_dim)
    v = prec.linear(h, p["attn.wv"].reshape(w.d_model, -1)).reshape(
        s, w.n_kv_heads, w.head_dim)
    q, k = rope(q, pos, w.rope_theta), rope(k, pos, w.rope_theta)
    o = attention(q, k, v, prec, q_block).reshape(s, -1)
    x = x + prec.linear(o, p["attn.wo"].reshape(-1, w.d_model))
    h = rmsnorm(x, p["mlp_norm.scale"], w.eps)
    gate = F.silu(prec.linear(h, p["mlp.w_gate"]))
    up = prec.linear(h, p["mlp.w_up"])
    return x + prec.linear(gate * up, p["mlp.w_down"])


def logits(x, final_scale, emb, w: Widths, prec: Precision):
    """Final norm and the tied head: x [S, d] -> [S, vocab]."""
    return prec.linear(rmsnorm(x, final_scale, w.eps), emb.t())

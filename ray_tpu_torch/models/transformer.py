"""Flagship model: llama-style decoder transformer in PyTorch.

Counterpart: ray_tpu/models/transformer.py. The public layouts are the
reference's: q/k/v [B, S, H, D], slot caches [B, max_seq, KV, D], f32
logits, weights stored in the flax layouts (`wq`/`wk`/`wv` [d_model, H, hd],
`wo` [H, hd, d_model], dense kernels [in, out], norms' `scale`, `tok_emb`
[vocab, d_model] tied to the output head), so `models/convert.py` carries
JAX weights across by renaming alone.

- The full-sequence forward (`cache=None`, the reference's decode=False)
  runs attention through `ops.dot_product_attention`: the flash kernel on
  the card.
- The slot-cache forward (`cache=` per-layer tensors from `new_cache`, the
  reference's decode=True) writes the new k/v rows in place at each
  sequence's own positions. Single-token steps run the decode kernel on
  the card; S > 1 (prefill) is the reference's dense masked attention.
- Params are f32 by default and cast to `dtype` at use; RMSNorm and RoPE
  compute in f32 and cast back; dense products are torch.matmul.

Not ported yet: MoE (`moe_experts > 0` raises), the TP/SP sharding rules
(`param_specs`, `_seq_shard`) and `loss_fn`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops import decode_attention, dot_product_attention


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8  # < n_heads => GQA
    d_ff: int = 1376  # ~8/3 * d_model, SwiGLU
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    #: >0 selects the MoE MLP, which this port does not have yet.
    moe_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rope(x, positions, theta: float):
    """Rotary position embeddings over split halves (not interleaved
    pairs). x: [B, S, H, D], positions: [B, S]."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _param(shape, param_dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd, pd = cfg.d_model, cfg.head_dim, cfg.param_dtype
        self.wq = _param((d, cfg.n_heads, hd), pd, device)
        self.wk = _param((d, cfg.n_kv_heads, hd), pd, device)
        self.wv = _param((d, cfg.n_kv_heads, hd), pd, device)
        self.wo = _param((cfg.n_heads, hd, d), pd, device)

    def _proj(self, x, w):
        """DenseGeneral over the last axis: x [B, S, d] @ w [d, H, hd]."""
        dt = self.cfg.dtype
        out = torch.matmul(x.to(dt), w.to(dt).reshape(w.shape[0], -1))
        return out.reshape(*x.shape[:-1], w.shape[1], w.shape[2])

    def forward(self, x, positions, cache=None):
        cfg = self.cfg
        q = _rope(self._proj(x, self.wq), positions, cfg.rope_theta)
        k = _rope(self._proj(x, self.wk), positions, cfg.rope_theta)
        v = self._proj(x, self.wv)
        if cache is not None:
            out = self._cached_attention(q, k, v, positions, cache)
        else:
            out = dot_product_attention(q, k, v, causal=True)
        wo = self.wo.to(cfg.dtype).reshape(-1, cfg.d_model)
        return torch.matmul(out.to(cfg.dtype).flatten(-2), wo)

    def _cached_attention(self, q, k, v, positions, cache):
        """Slot-cache attention with per-sequence positions: the new k/v
        rows are written in place into this layer's [B, L, KV, D] cache
        tensors at each sequence's own positions; query i of sequence b
        sees cache rows t <= positions[b, i], so rows past a sequence's
        position (stale slot contents) are never visible."""
        cfg = self.cfg
        ck, cv = cache
        b, s = q.shape[0], q.shape[1]
        pos = positions.to(torch.long)
        bidx = torch.arange(b, device=q.device)[:, None].expand(b, s)
        ck[bidx, pos] = k.to(ck.dtype)
        cv[bidx, pos] = v.to(cv.dtype)
        if s == 1:
            lengths = (pos[:, 0] + 1).to(torch.int32)
            out = decode_attention(q[:, 0].to(ck.dtype), ck, cv, lengths)
            return out[:, None].to(cfg.dtype)
        keys, vals = ck, cv
        if cfg.n_kv_heads < cfg.n_heads:  # GQA: broadcast kv heads
            rep = cfg.n_heads // cfg.n_kv_heads
            keys = keys.repeat_interleave(rep, dim=2)
            vals = vals.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q.float(),
                              keys.float()) / (cfg.head_dim ** 0.5)
        t_pos = torch.arange(ck.shape[1], device=q.device)[None, None, None, :]
        q_pos = pos[:, None, :, None]
        scores = scores.masked_fill(t_pos > q_pos, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhst,bthd->bshd", probs, vals.float())
        return out.to(cfg.dtype)


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.w_gate = _param((d, ff), pd, device)
        self.w_up = _param((d, ff), pd, device)
        self.w_down = _param((ff, d), pd, device)

    def forward(self, x):
        dt = self.cfg.dtype
        x = x.to(dt)
        gate = F.silu(torch.matmul(x, self.w_gate.to(dt)))
        up = torch.matmul(x, self.w_up.to(dt))
        return torch.matmul(gate * up, self.w_down.to(dt))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError(
                "MoE blocks are not ported to ray_tpu_torch yet")
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        self.mlp = SwiGLU(cfg, device=device)

    def forward(self, x, positions, cache=None):
        x = x + self.attn(self.attn_norm(x), positions, cache=cache)
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """tokens [B, S] -> logits [B, S, vocab] (f32).

    Weights start random from `seed` (normal(0.02) embedding, lecun-normal
    kernels, unit norms; the same on every device) and are replaced by `load_state_dict`, e.g. with
    `convert.params_from_flax`'s output. `device` defaults to "cuda" and
    raises where there is no CUDA."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.tok_emb = _param((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                              dev)
        self.layers = nn.ModuleList(
            Block(cfg, device=dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=dev)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        """Drawn on the CPU and copied, so a seed gives the same weights on
        every device."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            # normal(0.02) embedding; lecun normal over the contracted
            # (input) axes for the kernels
            std = 0.02 if name == "tok_emb" else (
                p.shape[0] * (p.shape[1] if name.endswith("wo") else 1)
            ) ** -0.5
            p.copy_(torch.empty(p.shape, dtype=p.dtype).normal_(
                0.0, std, generator=gen))

    def new_cache(self, batch: int, length: int | None = None):
        """Zeroed per-layer slot caches: a list of (k, v), each
        [batch, length or max_seq, KV, D] in the compute dtype."""
        cfg = self.cfg
        shape = (batch, length or cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=cfg.dtype, device=self.device))
                for _ in range(cfg.n_layers)]

    def forward(self, tokens, positions=None, cache=None):
        """tokens [B, S] int -> logits [B, S, vocab] f32. With `cache`
        (from new_cache), pass absolute `positions` [B, S]; the caches are
        updated in place."""
        cfg = self.cfg
        x = self.tok_emb[tokens].to(cfg.dtype)
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device).expand(tokens.shape)
        for i, block in enumerate(self.layers):
            x = block(x, positions,
                      cache=None if cache is None else cache[i])
        x = self.final_norm(x)
        # Tied output head.
        return torch.matmul(x, self.tok_emb.to(cfg.dtype).t()).to(torch.float32)

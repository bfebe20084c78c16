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
  compute in f32 and cast back; dense products are torch.matmul. RMSNorm
  is `ops.rms_norm`: one kernel each way on the card (the backward also
  adds the block's residual gradient), the plain formula on the CPU.
- `moe_experts > 0` swaps each block's SwiGLU for `MoE`, the reference's
  top-2 dense-dispatch mixture of SwiGLU experts (router in f32, experts
  in the compute dtype; expert weights [E, d, ff] / [E, ff, d]).
- While a torch profiler records, each layer's work lies in a
  `tracing.device_span`: `tf.embed`, `tf.block` (its self time the
  residual adds), `tf.norm`, `tf.cast` (a weight's cast to the compute
  dtype), `tf.attn.proj`, `tf.attn.rope`, `tf.attn.core`, `tf.mlp.proj`,
  `tf.mlp.act`, `tf.mlp.router` (MoE), `tf.head`, `tf.loss`. A backward
  op carries its forward op's sequence number in the trace, so the
  backward is charged to the same spans; no hook enters the graph, and
  with no profiler nothing is recorded.
- `loss_fn(model, tokens)` is the reference's next-token cross entropy.
  Training is autograd through the model; on the card the full-sequence
  attention's gradient is the flash backward kernel. A training step is
  `loss_fn(...).backward()` and `torch.optim.Adam(lr=1e-3).step()`, the
  update of `optax.adam(1e-3)` in the reference's step.
- `mesh=` (parallel/mesh.py) runs the model sharded, in shard_map's view:
  each rank's parameters are its local boxes under `param_specs` (the
  reference's rule table) and the forward runs on them with explicit
  collectives (parallel/collectives.py):
  - wq/wk/wv column-parallel over tp (heads over tp), wo row-parallel and
    a psum over tp; w_gate/w_up and w_down the same way;
  - tok_emb's vocab over tp: a masked lookup, then a psum; the tied head
    gives vocab-sharded logits, gathered by `forward` and reduced by the
    vocab-parallel cross entropy in `loss_fn`;
  - fsdp: parameters gathered on use; their gradients come back
    reduce-scattered, the transpose of the gather;
  - tokens are sharded over (dp, fsdp) by the caller; activations are
    sequence-sharded over sp between blocks (`_seq_shard`) and attention
    gathers the keys and values over sp, as GSPMD does in the reference;
  - the MoE's experts over ep, its combine reduced over ep (and tp);
  - a parameter replicated over a data axis is marked used per rank
    (`pvary`), so its gradient is summed over that axis by autograd.
  The gradients of `loss_fn(...).backward()` are then each rank's boxes of
  the unsharded model's gradients. With no mesh nothing changes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tracing import device_span
from ray_tpu_torch.ops import (decode_attention, dot_product_attention,
                               rms_norm)
from ray_tpu_torch.parallel.collectives import (all_gather,
                                                all_gather_invariant, pmax,
                                                psum, pvary)
from ray_tpu_torch.parallel.mesh import (P, shard_tensor, spec_axes,
                                         spec_tree_like)

#: the axes activations are sharded over (batch over dp and fsdp, sequence
#: over sp): a parameter used on them varies over each of these
DATA_AXES = ("dp", "fsdp", "sp")


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
    #: >0 switches the MLP to a top-2 MoE with this many experts.
    moe_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rope(x, positions, theta: float):
    """Rotary position embeddings over split halves (not interleaved
    pairs). x: [B, S, H, D], positions: [B, S]."""
    with device_span("tf.attn.rope"):
        d = x.shape[-1]
        exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
        freqs = 1.0 / (theta ** exps)
        angles = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
        x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)


def _cast(w, dtype):
    """A weight in the compute dtype. The cast has a span of its own, so
    the product that uses it (and the cast's gradient back) are told
    apart in a profile."""
    with device_span("tf.cast"):
        return w.to(dtype)


def _param(shape, param_dtype, device, mesh=None, spec=None):
    """A parameter of global `shape`: this rank's box of it under a mesh."""
    if mesh is not None:
        shape = mesh.local_shape(shape, spec)
    return nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device))


def _rule(path: tuple[str, ...]) -> P:
    """The reference's sharding rule (ray_tpu/models/transformer.py,
    param_specs) on the port's parameter names: Megatron TP + fsdp."""
    last = path[-1]
    module = path[-2] if len(path) >= 2 else ""
    if last == "tok_emb":
        return P("tp", "fsdp")  # vocab over tp, d_model over fsdp
    if last == "router":
        return P("fsdp", None)
    if module == "moe" and last in ("w_gate", "w_up"):
        return P("ep", "fsdp", "tp")  # leading [E] axis over ep
    if module == "moe" and last == "w_down":
        return P("ep", "tp", "fsdp")
    if last in ("wq", "wk", "wv"):
        return P("fsdp", "tp", None)  # heads over tp
    if last == "wo":
        return P("tp", None, "fsdp")
    if last in ("w_gate", "w_up"):
        return P("fsdp", "tp")
    if last == "w_down":
        return P("tp", "fsdp")
    return P()  # norms: replicated


def param_specs(params) -> dict:
    """Spec tree matching `params` (a state_dict, or any tree keyed by the
    port's parameter names)."""
    return spec_tree_like(params, lambda path, leaf: _rule(path))


def _use(p, spec, mesh):
    """A parameter as its computation uses it under a mesh: gathered over
    fsdp where the spec shards it so (the gradient comes back
    reduce-scattered), and marked used per rank over the data axes it is
    replicated over (the gradient is summed over them)."""
    if mesh is None:
        return p
    for d, entry in enumerate(spec):
        if "fsdp" in spec_axes(entry):
            p = all_gather(p, "fsdp", mesh, dim=d)
    sharded = {a for entry in spec for a in spec_axes(entry)}
    return pvary(p, tuple(a for a in DATA_AXES if a not in sharded), mesh)


def _seq_shard(x, mesh):
    """This rank's block of the sequence axis (dim 1) over sp: activations
    between blocks are sequence-sharded (Megatron-SP); attention gathers
    the keys and values it needs."""
    n = mesh.size("sp") if mesh is not None else 1
    if n == 1:
        return x
    s = x.shape[1]
    if s % n:
        raise ValueError(f"sequence {s} does not divide over sp ({n})")
    i = mesh.index("sp")
    return x[:, i * s // n:(i + 1) * s // n]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-6, device=None,
                 mesh=None):
        super().__init__()
        self.eps = eps
        self.mesh = mesh
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x, residual: bool = False):
        """y, or (x, y) with `residual`: the block adds its branch to that
        x, so the kernel's backward adds the residual's gradient into dx."""
        scale = _use(self.scale, P(), self.mesh)
        with device_span("tf.norm"):
            return rms_norm(x, scale, self.eps, residual=residual)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        d, hd, pd = cfg.d_model, cfg.head_dim, cfg.param_dtype
        qkv, out = _rule(("wq",)), _rule(("wo",))
        self.wq = _param((d, cfg.n_heads, hd), pd, device, mesh, qkv)
        self.wk = _param((d, cfg.n_kv_heads, hd), pd, device, mesh, qkv)
        self.wv = _param((d, cfg.n_kv_heads, hd), pd, device, mesh, qkv)
        self.wo = _param((cfg.n_heads, hd, d), pd, device, mesh, out)

    def _proj(self, x, w):
        """DenseGeneral over the last axis: x [B, S, d] @ w [d, H, hd]."""
        dt = self.cfg.dtype
        w = _cast(_use(w, _rule(("wq",)), self.mesh), dt)
        with device_span("tf.attn.proj"):
            out = torch.matmul(x.to(dt), w.reshape(w.shape[0], -1))
        return out.reshape(*x.shape[:-1], w.shape[1], w.shape[2])

    def forward(self, x, positions, cache=None):
        cfg, mesh = self.cfg, self.mesh
        x = pvary(x, "tp", mesh)  # entering the tp-sharded region
        q = _rope(self._proj(x, self.wq), positions, cfg.rope_theta)
        k = _rope(self._proj(x, self.wk), positions, cfg.rope_theta)
        v = self._proj(x, self.wv)
        if cache is not None:
            with device_span("tf.attn.core"):
                out = self._cached_attention(q, k, v, positions, cache)
        else:
            if mesh is not None and mesh.size("sp") > 1:
                # this rank's queries see the keys up to its block's end
                end = (mesh.index("sp") + 1) * k.shape[1]
                k = all_gather(k, "sp", mesh, dim=1)[:, :end].contiguous()
                v = all_gather(v, "sp", mesh, dim=1)[:, :end].contiguous()
            with device_span("tf.attn.core"):
                out = dot_product_attention(q, k, v, causal=True)
        wo = _cast(_use(self.wo, _rule(("wo",)), mesh), cfg.dtype)
        with device_span("tf.attn.proj"):
            o = torch.matmul(out.to(cfg.dtype).flatten(-2),
                             wo.reshape(-1, cfg.d_model))
        return psum(o, "tp", mesh)

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
            rep = q.shape[2] // ck.shape[2]
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
    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.w_gate = _param((d, ff), pd, device, mesh, _rule(("w_gate",)))
        self.w_up = _param((d, ff), pd, device, mesh, _rule(("w_up",)))
        self.w_down = _param((ff, d), pd, device, mesh, _rule(("w_down",)))

    def forward(self, x):
        dt, mesh = self.cfg.dtype, self.mesh
        x = pvary(x, "tp", mesh).to(dt)  # column-parallel in, row-parallel out

        def w(name):
            return _cast(_use(getattr(self, name), _rule((name,)), mesh), dt)

        with device_span("tf.mlp.proj"):
            gate = torch.matmul(x, w("w_gate"))
            up = torch.matmul(x, w("w_up"))
        with device_span("tf.mlp.act"):
            h = F.silu(gate) * up
        with device_span("tf.mlp.proj"):
            out = torch.matmul(h, w("w_down"))
        return psum(out, "tp", mesh)


class MoE(nn.Module):
    """Top-2 mixture-of-experts SwiGLU with dense dispatch: every expert
    runs over every token and the combine weights the top-k experts' outputs
    by their renormalised router probabilities (no capacity, no dropping).
    Under a mesh each rank holds its experts' block over ep (and their d_ff
    block over tp): it combines its experts' outputs and the combine is
    reduced over ep and tp."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        e, d, ff, pd = cfg.moe_experts, cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.router = _param((d, e), torch.float32, device, mesh,
                             _rule(("moe", "router")))
        self.w_gate = _param((e, d, ff), pd, device, mesh,
                             _rule(("moe", "w_gate")))
        self.w_up = _param((e, d, ff), pd, device, mesh, _rule(("moe", "w_up")))
        self.w_down = _param((e, ff, d), pd, device, mesh,
                             _rule(("moe", "w_down")))

    def forward(self, x):
        dt, mesh = self.cfg.dtype, self.mesh

        def w(name):
            return _use(getattr(self, name), _rule(("moe", name)), mesh)

        router = w("router")
        with device_span("tf.mlp.router"):
            probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
            k = min(2, self.cfg.moe_experts)  # top-1 with one expert
            kth = torch.topk(probs, k, dim=-1).values[..., -1:]
            gates = torch.where(probs >= kth, probs, 0.0)
            gates = gates / gates.sum(dim=-1, keepdim=True)  # renormalise
        if mesh is not None:  # this rank's experts
            n_local = self.w_gate.shape[0]
            first = mesh.index("ep") * n_local
            gates = pvary(gates, ("tp", "ep"), mesh)[..., first:first + n_local]
            x = pvary(x, ("tp", "ep"), mesh)
        xc = x.to(dt)
        with device_span("tf.mlp.proj"):
            gate_h = torch.einsum("bsd,edf->ebsf", xc,
                                  _cast(w("w_gate"), dt))
            up_h = torch.einsum("bsd,edf->ebsf", xc, _cast(w("w_up"), dt))
        with device_span("tf.mlp.act"):
            h = F.silu(gate_h) * up_h
        with device_span("tf.mlp.proj"):
            expert_out = torch.einsum("ebsf,efd->ebsd", h,
                                      _cast(w("w_down"), dt))
            out = torch.einsum("ebsd,bse->bsd", expert_out, gates.to(dt))
        return psum(out, ("tp", "ep"), mesh)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, device=device, mesh=mesh)
        self.attn = Attention(cfg, device=device, mesh=mesh)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device, mesh=mesh)
        # named as the flax modules are, so state_dict keys follow the tree
        if cfg.moe_experts:
            self.moe = MoE(cfg, device=device, mesh=mesh)
        else:
            self.mlp = SwiGLU(cfg, device=device, mesh=mesh)

    def forward(self, x, positions, cache=None):
        with device_span("tf.block"):
            x, h = self.attn_norm(x, residual=True)
            x = x + self.attn(h, positions, cache=cache)
            ffn = self.moe if hasattr(self, "moe") else self.mlp
            x, h = self.mlp_norm(x, residual=True)
            return x + ffn(h)


class Transformer(nn.Module):
    """tokens [B, S] -> logits [B, S, vocab] (f32).

    Weights start random from `seed` (normal(0.02) embedding and router,
    lecun-normal kernels, unit norms; the same on every device) and are
    replaced by `load_state_dict`, e.g. with
    `convert.params_from_flax`'s output. `device` defaults to "cuda" and
    raises where there is no CUDA.

    With `mesh`, every parameter is this rank's box of the unsharded
    model's (the same seed gives the same full weights, cut by
    `param_specs`; load a full state_dict through `parallel.shard_params`),
    `tokens` are this rank's rows of the batch, and the logits are this
    rank's rows and, over sp, its block of the sequence."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda", seed: int = 0,
                 mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.mesh = mesh
        self.tok_emb = _param((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                              dev, mesh, _rule(("tok_emb",)))
        self.layers = nn.ModuleList(
            Block(cfg, device=dev, mesh=mesh) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=dev, mesh=mesh)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        """Drawn on the CPU and copied, so a seed gives the same weights on
        every device (and, under a mesh, every rank its box of them)."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            spec = _rule(tuple(name.split(".")))
            shape = (p.shape if self.mesh is None
                     else self.mesh.global_shape(p.shape, spec))
            # normal(0.02) embedding and router; lecun normal for the
            # kernels, with flax's fan-in: the input axis of wq/wk/wv
            # [d, H, hd], every axis but the last of the others ([in, out],
            # wo [H, hd, d], and the experts [E, in, out], whose E counts
            # into the fan-in as in flax's lecun_normal)
            if name == "tok_emb" or name.endswith("router"):
                std = 0.02
            elif name.endswith(("wq", "wk", "wv")):
                std = shape[0] ** -0.5
            else:
                std = math.prod(shape[:-1]) ** -0.5
            full = torch.empty(shape, dtype=p.dtype).normal_(
                0.0, std, generator=gen)
            if self.mesh is not None:
                full = shard_tensor(full, spec, self.mesh)
            p.copy_(full)

    def new_cache(self, batch: int, length: int | None = None):
        """Zeroed per-layer slot caches: a list of (k, v), each
        [batch, length or max_seq, KV, D] in the compute dtype (KV: this
        rank's kv heads under a mesh)."""
        cfg = self.cfg
        kv = cfg.n_kv_heads // (self.mesh.size("tp") if self.mesh else 1)
        shape = (batch, length or cfg.max_seq, kv, cfg.head_dim)
        return [(torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=cfg.dtype, device=self.device))
                for _ in range(cfg.n_layers)]

    def _embed(self, tokens, emb):
        """Embedding lookup; under tp a masked lookup of this rank's vocab
        rows, then a psum."""
        mesh = self.mesh
        if mesh is None or mesh.size("tp") == 1:
            return emb[tokens].to(self.cfg.dtype)
        n_local = emb.shape[0]
        local = tokens - mesh.index("tp") * n_local
        inside = (local >= 0) & (local < n_local)
        rows = emb[local.clamp(0, n_local - 1)] * inside[..., None]
        return psum(rows, "tp", mesh).to(self.cfg.dtype)

    def forward(self, tokens, positions=None, cache=None, gather: bool = True):
        """tokens [B, S] int -> logits [B, S, vocab] f32. With `cache`
        (from new_cache), pass absolute `positions` [B, S]; the caches are
        updated in place. Under tp, `gather=False` returns this rank's
        vocab block of the logits."""
        cfg, mesh = self.cfg, self.mesh
        if cache is not None and mesh is not None and mesh.size("sp") > 1:
            raise ValueError("the slot-cache forward needs sp = 1")
        emb = _use(self.tok_emb, _rule(("tok_emb",)), mesh)
        with device_span("tf.embed"):
            if positions is None:
                positions = torch.arange(
                    tokens.shape[1], device=tokens.device).expand(tokens.shape)
            if cache is None:
                tokens = _seq_shard(tokens, mesh)
                positions = _seq_shard(positions, mesh)
            x = self._embed(tokens, emb)
        for i, block in enumerate(self.layers):
            x = block(x, positions,
                      cache=None if cache is None else cache[i])
        x = self.final_norm(x)
        # Tied output head (vocab-sharded under tp).
        head = _cast(emb, cfg.dtype)
        with device_span("tf.head"):
            logits = torch.matmul(pvary(x, "tp", mesh),
                                  head.t()).to(torch.float32)
        return all_gather_invariant(logits, "tp", mesh, dim=-1) \
            if gather else logits


def _vocab_parallel_nll(logits, targets, mesh):
    """-log softmax(logits)[target] per row, for logits [N, V/tp] holding
    this rank's vocab block: the max and the sum of exponentials are
    reduced over tp, and so is the target's logit."""
    n_local = logits.shape[-1]
    m = pmax(logits.amax(dim=-1), "tp", mesh)
    z = psum(torch.exp(logits - m[:, None]).sum(dim=-1), "tp", mesh)
    local = targets - mesh.index("tp") * n_local
    inside = (local >= 0) & (local < n_local)
    picked = logits.gather(-1, local.clamp(0, n_local - 1)[:, None])[:, 0]
    return torch.log(z) + m - psum(picked * inside, "tp", mesh)


def loss_fn(model: Transformer, tokens):
    """Next-token cross entropy, mean over all positions: the logits of
    tokens[:, :-1] against tokens[:, 1:]. Under a mesh `tokens` are this
    rank's rows; the loss is the global mean, equal on every rank."""
    mesh = model.mesh
    if mesh is None:
        logits = model(tokens[:, :-1])
        with device_span("tf.loss"):
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   tokens[:, 1:].reshape(-1))
    logits = model(tokens[:, :-1], gather=False)
    with device_span("tf.loss"):
        targets = _seq_shard(tokens[:, 1:], mesh)
        nll = _vocab_parallel_nll(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1), mesh)
        count = tokens[:, 1:].numel() * mesh.size(("dp", "fsdp"))
        return psum(nll.sum(), DATA_AXES, mesh) / count

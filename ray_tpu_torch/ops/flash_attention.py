"""Flash attention: blockwise online-softmax attention and its gradient.

On a CUDA tensor `flash_attention` launches the hand-written forward kernel
(`csrc/flash_attention.cu`); on a CPU tensor it runs the plain version,
`_reference_flash_attention`, which computes the same function densely.
Any Sq/Sk is taken (the kernel masks its ragged edge itself), with GQA and
a causal diagonal offset of Sk - Sq. A query row that sees no key (causal
with Sq > Sk) comes out as zeros in both.

When autograd needs a gradient (grad mode on and an input that requires
grad), the call goes through `_FlashAttention`: its forward also writes
the logsumexp of each row, its backward launches the backward kernel
(`csrc/flash_attention_bwd.cu`) on CUDA tensors and runs the plain
`_reference_flash_attention_backward` on CPU tensors. Under
`torch.no_grad()` no logsumexp is computed. The bf16 backward adds dq
through f32 bulk reduce-adds in the L2, in an order that changes from run
to run, so its last bit may differ between two calls on the same inputs;
dk and dv do not (where blocks share a KV head's query heads,
`bwd_head_split`, their partial sums are added in a fixed order). The
f32 backward sums everything in a fixed order: dq, dk and dv are bitwise
repeatable.

Head dims: every multiple of 8 from 8 to 256 (the JAX package's Pallas
kernel takes any D); the kernels' instances and tiles are named by
`kernel_tile`. Outside the rule the wrappers raise a ValueError that
states it.

Counterpart: ray_tpu/ops/flash_attention.py (`flash_attention`). The JAX
package's Pallas kernel has no gradient rule; its gradient is XLA's, of
`_xla_attention` (ray_tpu/ops/attention.py).
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.kernels import HEAD_DIM_RULE, supported_head_dim

# Head dims with instances of their own: these four in both kernels' bf16
# paths, and Phi-2's and Phi-3-mini's 80 and 96 in the bf16 forward
# (faster there than the tile of 128; the backward's were not). Any other D
# the rule takes, and every f32 D, runs on the instance of its tile width
# (kernel_tile) with D as an argument.
EXACT_HEAD_DIMS = (16, 32, 64, 128)
EXACT_BF16_FORWARD_HEAD_DIMS = EXACT_HEAD_DIMS + (80, 96)


def kernel_tile(d: int) -> int:
    """The flash kernels' tile width (columns of a row in shared memory) for
    head dim d: the power of two at or above it, at least 16 (two 64-column
    panels at D = 80 and 96; flash_attention_bwd.cu, tile_of)."""
    return next(t for t in (16, 32, 64, 128, 256) if t >= d)


def bwd_head_split(b: int, sk: int, hq: int, hkv: int, d: int,
                   sms: int) -> int:
    """Blocks that share one KV head's query heads in the bf16 backward: the
    least divisor of Hq / Hkv that brings the grid (KV heads x B x key
    tiles) to the card's `sms` multiprocessors, or all of them. With few KV
    heads (GQA, Gemma's one) a block per key tile leaves most of the card
    idle. Each block of a split writes its dK and dV partial to a slot of
    an f32 scratch, and the slots are added in order, so dk and dv stay
    bitwise repeatable."""
    rep = hq // hkv
    blocks = hkv * b * -(-sk // BWD_TILES[d][0])
    return next((h for h in range(1, rep + 1)
                 if rep % h == 0 and blocks * h >= sms), rep)


# The bf16 backward kernel's tiles by head dim: (keys, query rows). One
# block owns a key tile and steps over query tiles; the scratch rows are
# padded to a multiple of the query tile. The kernel refuses any other pair.
BWD_TILES = {d: ((64, 64) if kernel_tile(d) == 256 else
                 (128, 64) if kernel_tile(d) == 128 else (128, 128))
             for d in range(8, 257, 8)}


def _compute_dtype(dtype):
    """The plain versions' arithmetic: f32 for bf16 and f32 inputs, f64 for
    f64 (so gradcheck can run them)."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal: bool):
    """Scaled scores [B, Hq, Sq, Sk] in the compute dtype, with keys a row
    does not see at -inf; k repeated over its group of query heads."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    acc = _compute_dtype(q.dtype)
    k = k.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * d ** -0.5
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~visible, float("-inf"))
    return scores


def _reference_flash_attention_lse(q, k, v, causal: bool = True):
    """Plain version (any device) of the forward with its logsumexp:
    q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> (out [B, Sq, Hq, D] in q's
    dtype, lse [B, Hq, Sq] in the compute dtype, natural log). Scores,
    softmax and the PV product in f32 (f64 for f64 inputs); a row with no
    visible key has lse -inf and output zeros."""
    scores = _scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1)
    finite = torch.isfinite(lse)
    probs = torch.exp(scores - torch.where(finite, lse, 0.0)[..., None])
    v = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype))
    return out.to(q.dtype), lse


def _reference_flash_attention(q, k, v, causal: bool = True):
    """Plain version (any device): the output of
    `_reference_flash_attention_lse`."""
    return _reference_flash_attention_lse(q, k, v, causal)[0]


def _reference_flash_attention_backward(q, k, v, out, dout, lse,
                                        causal: bool = True):
    """Plain backward (any device), computed from `lse` and
    Delta = rowsum(dO * O) as the kernel computes it: P = exp(S - lse),
    dV = P^T dO, dS = P (dP - Delta), dK = scale dS^T Q, dQ = scale dS K,
    dk/dv summed over each KV head's query heads. Delta comes from the
    returned O (already rounded to its dtype); P and dS are rounded to q's
    dtype before the products, as the kernel's operands are. A row with no
    visible key contributes nothing and gets dq = 0. Returns (dq, dk, dv)
    in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    acc = _compute_dtype(q.dtype)
    scale = d ** -0.5
    scores = _scores(q, k, causal)
    lse = lse.to(acc)
    keep = torch.isfinite(scores) & torch.isfinite(lse)[..., None]
    p = torch.exp(torch.where(keep, scores - lse[..., None],
                              float("-inf")))
    do32 = dout.to(acc)
    delta = torch.einsum("bqhd,bqhd->bhq", do32, out.to(acc))
    vr = v.repeat_interleave(rep, dim=2).to(acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, vr)
    ds = p * (dp - delta[..., None])
    p, ds = p.to(q.dtype).to(acc), ds.to(q.dtype).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      k.repeat_interleave(rep, dim=2).to(acc)) * scale
    dk = dk.reshape(b, sk, hkv, rep, d).sum(3)
    dv = dv.reshape(b, sk, hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(what: str, q, k, v, *more):
    """Shape, head-dim, device, dtype and layout checks shared by the
    forward and backward wrappers; `more` are tensors shaped like q."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)} must be "
            f"[B, Sq, Hq, D], k {tuple(k.shape)} and v {tuple(v.shape)} "
            f"equal [B, Sk, Hkv, D]")
    b, sq, hq, d = q.shape
    kb, sk, hkv, kd = k.shape
    if kb != b or kd != d or hq % hkv or sk == 0:
        raise ValueError(
            f"{what} shapes disagree: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} (need equal B and D, Hq % Hkv == 0, Sk > 0)")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{what}: o and dO must be shaped like q "
                         f"{tuple(q.shape)}, got "
                         f"{[tuple(t.shape) for t in more]}")
    if not supported_head_dim(d):
        raise ValueError(
            f"{what} kernel takes head dims that are {HEAD_DIM_RULE}; "
            f"got D={d} for q {tuple(q.shape)}")
    tensors = (q, k, v, *more)
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{what} dtypes differ: "
                         f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{what} inputs must be contiguous and 16-byte "
                         "aligned")
    return kernels.dtype_code(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool = True, *,
                         with_lse: bool = False):
    """Launch the forward kernel on the current stream, without
    synchronising. q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], one dtype (float32
    or bfloat16), contiguous, on one CUDA device. Returns [B, Sq, Hq, D], or
    (out, lse f32 [B, Hq, Sq]) when `with_lse`."""
    code = _check_inputs("flash attention", q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.FLASH_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, sk, hq, hkv, d, int(causal), code, stream, head_dim=d)
    return (out, lse) if with_lse else out


def flash_attention_backward_cuda(q, k, v, out, dout, lse,
                                  causal: bool = True):
    """Launch the backward kernel on the current stream, without
    synchronising: q/out/dout [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] of one
    dtype (float32 or bfloat16), contiguous, on one CUDA device; lse the
    forward's f32 [B, Hq, Sq]. The kernel's f32 scratch is allocated here.
    Returns (dq, dk, dv)."""
    code = _check_inputs("flash attention backward", q, k, v, out, dout)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if (tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash attention backward: lse must be contiguous "
                         f"float32 [{b}, {hq}, {sq}] on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    block_k, block_q = BWD_TILES[d]
    f32 = dict(dtype=torch.float32, device=q.device)
    hsplit, dkv_accum = 1, None
    if q.dtype == torch.bfloat16:  # Delta, lse in log2 and dQ's accumulator
        rows = -(-sq // block_q) * block_q
        delta = torch.empty(b, hq, rows, **f32)
        lse_log2 = torch.empty(b, hq, rows, **f32)
        # tile-major (flash_attention_bwd.cu, dq_block_offset)
        dq_accum = torch.empty(b * hq * rows * d, **f32)
        hsplit = bwd_head_split(b, sk, hq, hkv, d, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        if hsplit > 1:  # a slot of dK and dV partials per share
            dkv_accum = torch.empty(hsplit, 2, b, sk, hkv, d, **f32)
    else:
        delta, lse_log2, dq_accum = torch.empty(b, hq, sq, **f32), None, None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.FLASH_ATTENTION_BWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if lse_log2 is None else lse_log2.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d, int(causal),
            code, block_k, block_q,
            None if dkv_accum is None else dkv_accum.data_ptr(), hsplit,
            stream, head_dim=d)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient. The forward saves q, k, v, the
    output and the logsumexp (never P); the backward recomputes P from
    them. CUDA tensors go to the kernels, CPU tensors to the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = _reference_flash_attention_lse(q, k, v, causal)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # the gradient reaching attention comes through reshapes and a
        # matmul, and need not be contiguous; the kernel takes rows in place
        dout = dout.contiguous()
        if q.device.type == "cpu":
            grads = _reference_flash_attention_backward(q, k, v, out, dout,
                                                        lse, ctx.causal)
        else:
            grads = flash_attention_backward_cuda(q, k, v, out, dout, lse,
                                                  ctx.causal)
        return (*grads, None)


def flash_attention(q, k, v, causal: bool = True):
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]. CUDA tensors
    go to the kernels, CPU tensors to the plain versions; differentiable
    when autograd needs it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return _reference_flash_attention(q, k, v, causal)
    return flash_attention_cuda(q, k, v, causal)

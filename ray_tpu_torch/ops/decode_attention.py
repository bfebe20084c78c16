"""Decode attention: single-token queries against a slot KV cache.

The serving hot loop's attention: q [B, Hq, D], one new token per sequence,
against fixed [B, S, KV, D] caches with per-sequence valid lengths. On a
CUDA tensor `decode_attention` launches the hand-written kernel
(`csrc/decode_attention.cu`); on a CPU tensor it runs the plain version,
`_reference_decode_attention`. There is no size threshold and no fallback:
a CUDA input the kernel does not take raises.

Counterpart: ray_tpu/ops/decode_attention.py (`decode_attention_pallas`,
`_xla_decode_attention`, `decode_attention`).
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private import kernels

SUPPORTED_HEAD_DIMS = (64, 128)


def _reference_decode_attention(q, k_cache, v_cache, lengths):
    """Plain version (any device): masked dense attention over the cache,
    softmax in f32, output in q's dtype. A sequence with length 0 gives NaN
    here (the kernel gives zeros); the engine never has length 0."""
    b, hq, d = q.shape
    _, sk, hkv, _ = k_cache.shape
    if hkv < hq:
        rep = hq // hkv
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.float(),
                          k_cache.float()) / (d ** 0.5)
    mask = (torch.arange(sk, device=q.device)[None, None, :]
            < lengths.to(q.device)[:, None, None])
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs, v_cache.float())
    return out.to(q.dtype)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the CUDA kernel on the current stream, without synchronising.
    q [B, Hq, D]; caches [B, S, KV, D] of q's dtype (float32 or bfloat16);
    lengths [B] int32 on the same card (rows [0, len) valid, including the
    token just written). Returns [B, Hq, D]."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"decode attention shapes: q {tuple(q.shape)} must be [B, Hq, D], "
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} equal "
            f"[B, S, KV, D]")
    b, hq, d = q.shape
    kb, s, kv, kd = k_cache.shape
    if kb != b or kd != d or hq % kv:
        raise ValueError(
            f"decode attention shapes disagree: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} (need equal B and D, Hq % KV == 0)")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"decode attention kernel takes head dims {SUPPORTED_HEAD_DIMS}; "
            f"got D={d} for q {tuple(q.shape)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(
            f"lengths must be int32 [{b}], got {lengths.dtype} "
            f"{tuple(lengths.shape)}")
    tensors = (q, k_cache, v_cache, lengths)
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("decode attention: every input must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"decode attention dtypes differ: q {q.dtype}, "
                         f"k {k_cache.dtype}, v {v_cache.dtype}")
    code = kernels.dtype_code(q.dtype)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("decode attention inputs must be contiguous and "
                         "16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.DECODE_ATTENTION.launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, hq, kv, s, d, code, stream)
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """q [B, Hq, D]; caches [B, S, KV, D]; lengths [B] -> [B, Hq, D].
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if q.device.type == "cpu":
        return _reference_decode_attention(q, k_cache, v_cache, lengths)
    return decode_attention_cuda(q, k_cache, v_cache, lengths)

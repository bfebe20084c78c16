"""Flash attention forward: blockwise online-softmax attention.

On a CUDA tensor `flash_attention` launches the hand-written kernel
(`csrc/flash_attention.cu`); on a CPU tensor it runs the plain version,
`_reference_flash_attention`, which computes the same function densely.
Any Sq/Sk is taken (the kernel masks its ragged edge itself), with GQA and
a causal diagonal offset of Sk - Sq. A query row that sees no key (causal
with Sq > Sk) comes out as zeros in both.

Counterpart: ray_tpu/ops/flash_attention.py (`flash_attention`).
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private import kernels

SUPPORTED_HEAD_DIMS = (64, 128)


def _reference_flash_attention(q, k, v, causal: bool = True):
    """Plain version (any device): q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D].
    Scores, softmax and the PV product in f32; output in q's dtype; rows
    with no visible key are zeros."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if not causal:
        probs = torch.softmax(scores, dim=-1)
    else:
        visible = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril(diagonal=sk - sq)
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")),
                              dim=-1)
        probs = probs.masked_fill(~visible.any(-1)[:, None], 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch the CUDA kernel on the current stream, without synchronising.
    q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], one dtype (float32 or bfloat16),
    contiguous, on one CUDA device. Returns [B, Sq, Hq, D]."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash attention shapes: q {tuple(q.shape)} must be "
            f"[B, Sq, Hq, D], k {tuple(k.shape)} and v {tuple(v.shape)} "
            f"equal [B, Sk, Hkv, D]")
    b, sq, hq, d = q.shape
    kb, sk, hkv, kd = k.shape
    if kb != b or kd != d or hq % hkv or sk == 0:
        raise ValueError(
            f"flash attention shapes disagree: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} (need equal B and D, Hq % Hkv == 0, Sk > 0)")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash attention kernel takes head dims {SUPPORTED_HEAD_DIMS}; "
            f"got D={d} for q {tuple(q.shape)}")
    tensors = (q, k, v)
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("flash attention: every input must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention dtypes differ: q {q.dtype}, "
                         f"k {k.dtype}, v {v.dtype}")
    code = kernels.dtype_code(q.dtype)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("flash attention inputs must be contiguous and "
                         "16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.FLASH_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, hq, hkv, d, int(causal), code, stream)
    return out


def flash_attention(q, k, v, causal: bool = True):
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]. CUDA tensors
    go to the kernel, CPU tensors to the plain version."""
    if q.device.type == "cpu":
        return _reference_flash_attention(q, k, v, causal)
    return flash_attention_cuda(q, k, v, causal)

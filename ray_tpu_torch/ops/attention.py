"""Attention entry point of the models.

`dot_product_attention` sends a CUDA tensor to the flash kernel
(ops/flash_attention.py), differentiable through its backward kernel, and a
CPU tensor to `_reference_attention`, the plain version, differentiable by
autograd. Nothing is caught: a CUDA shape the kernel does not take raises
instead of running the plain version on the card.

Counterpart: ray_tpu/ops/attention.py (`dot_product_attention`,
`_xla_attention`).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(q, k, v, *, causal: bool = True):
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (GQA when Hq > Hkv) ->
    [B, Sq, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal)


def _reference_attention(q, k, v, *, causal: bool):
    """The reference's XLA path: logits in the input dtype, softmax in f32,
    probabilities cast to q's dtype before the PV product; masked entries
    take the f32 minimum, so a row with no visible key is the mean of V."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~visible, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)

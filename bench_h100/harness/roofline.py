"""Published peaks of one H100 and the operations and bytes the measured
work needs, computed from its shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 989 TFLOP/s in bf16
and 3.35 TB/s of HBM, at the full 700 W. A kernel's bound is the larger of
its operations over the peak rate and its bytes over the HBM rate, with
each input byte read once and each output byte written once, whatever the
kernel reads again.

`visible_pairs` and `flash_forward` follow the repository's chip smoke
script's `_visible_pairs` and `_flash_bound` (frozen here), without its
exponential roof, which is no published peak.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(row, key) pairs the attention computes: key j <= i + sk - sq,
    j < sk when causal."""
    if not causal:
        return sq * sk
    return sum(min(max(i + sk - sq + 1, 0), sk) for i in range(sq))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_forward(b, sq, sk, hq, hkv, d, causal=True, elem=2) -> dict:
    """The forward's products (Q K^T and P V: 4 B Hq D flops a visible
    pair) and bytes (q, k, v read, out written, and the f32 logsumexp per
    row written where autograd asks for it)."""
    pairs = visible_pairs(sq, sk, causal)
    flops = 4 * b * hq * d * pairs
    io = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elem
    lse = 4 * b * hq * sq
    return {"pairs": pairs, "flops": flops, "bytes": io + lse,
            "bytes_without_lse": io, "bound_s": bound_s(flops, io + lse)}


def flash_backward(b, sq, sk, hq, hkv, d, causal=True, elem=2) -> dict:
    """The four products the gradient needs (dV = P^T dO, dP = dO V^T,
    dQ = dS K, dK = dS^T Q: 8 B Hq D flops a visible pair); the scores'
    recompute is the kernel's own choice and is not counted. Bytes: q, k,
    v, out, dout and the logsumexp read, dq, dk and dv written."""
    pairs = visible_pairs(sq, sk, causal)
    flops = 8 * b * hq * d * pairs
    q_like = b * sq * hq * d * elem
    kv_like = b * sk * hkv * d * elem
    nbytes = 4 * q_like + 4 * kv_like + 4 * b * hq * sq
    return {"pairs": pairs, "flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, nbytes)}


def matmul_params(m: dict) -> int:
    """Parameters that enter a product per token: every layer's
    projections and MLP, and the tied head (the embedding's lookup is
    free). `m` holds the port's widths (d_model, n_layers, n_heads,
    n_kv_heads, d_ff, vocab_size)."""
    d, hd = m["d_model"], m["d_model"] // m["n_heads"]
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    mlp = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + mlp) + m["vocab_size"] * d


def attention_flops_forward(m: dict, pairs: int) -> float:
    """QK^T and PV over `pairs` visible (row, key) pairs of one sequence,
    every layer and head."""
    hd = m["d_model"] // m["n_heads"]
    return 4.0 * m["n_layers"] * m["n_heads"] * hd * pairs


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: 6 x matmul parameters x tokens, and
    the attention's forward products three times (forward and the
    backward's two of each)."""
    pairs = batch * visible_pairs(seq, seq, True)
    return 6.0 * matmul_params(m) * batch * seq + \
        3.0 * attention_flops_forward(m, pairs)


def prefill_flops(m: dict, prompt_len: int) -> float:
    """A prompt's model FLOPs: 2 x matmul parameters a token, and the
    causal attention over the prompt alone (no bucket padding)."""
    return 2.0 * matmul_params(m) * prompt_len + attention_flops_forward(
        m, prompt_len * (prompt_len + 1) // 2)


def decode_flops(m: dict, context: int) -> float:
    """One generated token's model FLOPs at a cache of `context` rows."""
    return 2.0 * matmul_params(m) + attention_flops_forward(m, context)

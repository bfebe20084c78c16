"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head sharding.

Counterpart: ray_tpu/ops/ulysses.py. Where ring attention keeps the
sequence sharded and rotates k/v, Ulysses reshards for the attention op:

    in:  q/k/v sharded over sequence  [B, S/n, H, D]
    all_to_all -> sharded over heads  [B, S, H/n, D]  (the full sequence
                                                       for 1/n of the heads)
    local attention (`dot_product_attention`: the flash kernel on the card)
    all_to_all back -> sequence-sharded output [B, S/n, H, D]

It caps the sequence-parallel degree at the head count.
"""

from __future__ import annotations

from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.parallel.collectives import all_to_all


def ulysses_attention(q, k, v, *, axis_name: str, mesh, causal: bool = True):
    """q [B, S_local, Hq, D] sequence-sharded over `axis_name` of `mesh`;
    k/v the same layout (kv heads must also divide the axis size). Returns
    the sequence-sharded output [B, S_local, Hq, D]."""
    n = mesh.size(axis_name) if mesh is not None else 1
    hq = q.shape[2]
    hkv = k.shape[2]
    if hq % n or hkv % n:
        raise ValueError(
            f"ulysses needs head counts divisible by the axis size "
            f"(q heads {hq}, kv heads {hkv}, axis {n})")

    def seq_to_heads(x):
        return all_to_all(x, axis_name, mesh, split_axis=2, concat_axis=1)

    def heads_to_seq(x):
        return all_to_all(x, axis_name, mesh, split_axis=1, concat_axis=2)

    out = dot_product_attention(seq_to_heads(q), seq_to_heads(k),
                                seq_to_heads(v), causal=causal)
    return heads_to_seq(out)

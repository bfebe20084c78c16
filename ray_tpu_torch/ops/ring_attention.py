"""Ring attention: sequence-parallel attention over a mesh axis.

Counterpart: ray_tpu/ops/ring_attention.py, the same algorithm. Each rank
holds a [B, S/n, H, D] block of q/k/v along the sequence. The k/v blocks
rotate around the ring (`ppermute_ring`) while every rank folds the
visiting block into its queries' online-softmax state (m, l, acc in f32),
so the full [Sq, Sk] score matrix never exists and k/v memory per rank
stays O(S/n).

- GQA stays folded as [b, s, hkv, rep, d]: k/v ride the ring at their
  native hkv width.
- Causality uses global positions: rank i's queries own rows
  [i*S/n, (i+1)*S/n); the block visiting at step s holds the keys of rank
  (i - s) mod n.
- Rows with no visible key in a block are guarded as the reference
  guards them (no -inf - -inf), and a row that saw no key at all is 0.

The block math is plain torch, as the reference's is einsums outside any
Pallas kernel. Forward only, as in the reference.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.collectives import ppermute_ring


def ring_attention(q, k, v, *, axis_name: str, mesh, causal: bool = True):
    """q [B, S_local, Hq, D], k/v [B, S_local, Hkv, D]: this rank's blocks
    of a sequence sharded over `axis_name` of `mesh`. Returns this rank's
    output block [B, S_local, Hq, D] in q's dtype."""
    n = mesh.size(axis_name) if mesh is not None else 1
    idx = mesh.index(axis_name) if mesh is not None else 0
    b, s_local, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scale = d ** -0.5
    dev = q.device
    qf = q.float().reshape(b, s_local, hkv, rep, d)
    q_pos = idx * s_local + torch.arange(s_local, device=dev)[:, None]
    m = torch.full((b, hkv, rep, s_local, 1), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, rep, s_local, 1), device=dev)
    acc = torch.zeros((b, hkv, rep, s_local, d), device=dev)
    k_cur, v_cur = k, v
    for step in range(n):
        owner = (idx - step) % n  # whose keys are visiting this step
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_cur.float()) * scale
        if causal:
            k_pos = owner * s_local + torch.arange(s_local, device=dev)[None]
            sc = sc.masked_fill(~(k_pos <= q_pos), float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        none_yet = torch.isinf(m_new)
        p = torch.exp(sc - torch.where(none_yet, 0.0, m_new))
        p = torch.where(none_yet, 0.0, p)
        alpha = torch.exp(m - m_new)
        alpha = torch.where(torch.isinf(m) & none_yet, 0.0, alpha)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, v_cur.float())
        m = m_new
        if step < n - 1:
            k_cur = ppermute_ring(k_cur, axis_name, mesh)
            v_cur = ppermute_ring(v_cur, axis_name, mesh)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).to(q.dtype)  # [B, Hkv, rep, Sq_local, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_local, hq, d)

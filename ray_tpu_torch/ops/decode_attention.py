"""Decode attention: single-token queries against a slot KV cache.

The serving hot loop's attention: q [B, Hq, D], one new token per sequence,
against fixed [B, S, KV, D] caches with per-sequence valid lengths. On a
CUDA tensor `decode_attention` launches the hand-written kernel
(`csrc/decode_attention.cu`); on a CPU tensor it runs the plain version,
`_reference_decode_attention`. There is no size threshold and no fallback:
a CUDA input the kernel does not take raises, and so does an input that
requires grad with grad mode on (the kernel has no backward; the engine
calls it under `torch.no_grad()`).

The kernel is split-K: `split_plan` (here, not in the kernel) chooses how
many query heads a block serves and how many cache rows one block reads,
and the wrapper hands the kernel a workspace for the partial results and a
buffer of zeroed int counters, both kept per device and stream. The kernel
merges the partials in the same launch and leaves the counters at zero.

Head dims: every multiple of 8 from 8 to 256 (the JAX package's Pallas
kernel takes any D). 16, 32, 64 and 128 have instances of their own; any
other D runs on the instance of its tile (`decode_tile`), whose lanes past
D load zeros and store nothing. Outside the rule the wrapper raises a
ValueError that states it.

Counterpart: ray_tpu/ops/decode_attention.py (`decode_attention_pallas`,
`_xla_decode_attention`, `decode_attention`).
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.kernels import HEAD_DIM_RULE, supported_head_dim

# Head dims with instances of their own; any other D the rule takes runs on
# the instance of its tile width (decode_tile) with D as an argument.
EXACT_HEAD_DIMS = (16, 32, 64, 128)
# Query heads one block serves (the kernel is built for these).
GROUP_SIZES = (1, 2, 4, 8)
# Blocks the grid should hold when every sequence fills the cache: about
# sixteen for each of the H100's 132 SMs. Longer caches get longer chunks
# rather than more blocks.
TARGET_BLOCKS = 2048
# A block reads at least this many rounds of loads: below that its fixed
# costs (the length, q, the ticket, the merge) outweigh its rows.
MIN_ROUNDS = 2
# At most this many chunks of one sequence: the last block of an item
# merges every chunk's partials alone. On an H100 (chip_width_probe.py)
# one sequence of 32,768 rows at D 64, 8 heads on one KV head, took 0.139
# ms in 256 chunks and 0.060 in 32; Gemma-2B's MQA decode at S8192 took
# 1.15 ms in 256 chunks and 0.078 in 32. Few items then leave most SMs
# idle, and still finish sooner.
MAX_SPLITS = 32


def decode_tile(d: int) -> int:
    """The kernel's tile width for head dim d: d itself at 16, 32, 64 and
    128, else the power of two at or above it (at least 8), whose instance
    takes d at run time (decode_attention.cu, rt_tile)."""
    if d in EXACT_HEAD_DIMS:
        return d
    return next(t for t in (8, 32, 64, 128, 256) if t >= d)


def max_group(d: int) -> int:
    """Query heads one block serves at most: 8, or 4 at the tile of 256
    (decode_attention.cu has no 8-head instance there)."""
    return 4 if decode_tile(d) == 256 else GROUP_SIZES[-1]


def rows_per_round(group: int, d: int, elem_bytes: int) -> int:
    """Cache rows a block of the kernel loads at once: its workers times
    the rows each keeps in flight. A worker is min(32, tile * elem_bytes /
    16) lanes, one 16-byte slice of the row each, so at D = 80 and 96 in
    bf16 (10 and 12 slices of data) it is 16 lanes of the tile of 128. The
    kernel runs 128 threads with 4 rows in flight per worker, or 256
    threads with 2 for groups of 4 or 8 query heads. At D = 16 in bf16 a
    worker is 2 lanes, so a round is 256 rows for every group."""
    threads, unroll = (256, 2) if group >= 4 else (128, 4)
    lanes = min(32, decode_tile(d) * elem_bytes // 16)
    return threads // lanes * unroll


class SplitPlan(NamedTuple):
    """How the kernel cuts one call: `group` query heads per block,
    `n_groups` blocks across a KV head's heads, `items` = B * KV * n_groups
    merge targets, cache chunks of `chunk` rows and `n_splits` of them
    (n_splits * chunk >= S). A block (item, split) reads rows
    [split * chunk, min((split + 1) * chunk, len)) and is active when that
    range is not empty, so ceil(len / chunk) blocks of an item are."""
    group: int
    n_groups: int
    items: int
    chunk: int
    n_splits: int


def split_plan(b: int, hq: int, kv: int, s: int, d: int,
               elem_bytes: int) -> SplitPlan:
    """Whole rounds of loads per chunk, at least MIN_ROUNDS of them, no
    more than about TARGET_BLOCKS blocks for a full cache, and at most
    MAX_SPLITS chunks. At the serving width (B8, KV16, S1024, D64, bf16)
    that is 128-row chunks and 8 splits: 544 active blocks on the smoke
    run's ragged lengths, four for each of the 132 SMs."""
    rep = hq // kv
    group = next(g for g in GROUP_SIZES if g >= min(rep, max_group(d)))
    n_groups = -(-rep // group)
    items = b * kv * n_groups
    rows = rows_per_round(group, d, elem_bytes)
    rounds = max(MIN_ROUNDS, math.ceil(s * items / TARGET_BLOCKS / rows),
                 math.ceil(s / MAX_SPLITS / rows),
                 math.ceil(s / 65535 / rows))  # the grid's y limit
    chunk = rows * rounds
    return SplitPlan(group, n_groups, items, chunk, max(1, -(-s // chunk)))


_scratch: dict = {}
_scratch_lock = threading.Lock()


def _workspace(device, stream: int, n_floats: int, n_counters: int):
    """The (workspace, counters) pair of one device and stream, grown as
    needed. Counters start at zero and every launch leaves them at zero;
    calls on one stream are ordered, so they can share the pair."""
    key = (device, stream)
    with _scratch_lock:
        ws, counters = _scratch.get(key, (None, None))
        if ws is None or ws.numel() < n_floats:
            ws = torch.empty(n_floats, dtype=torch.float32, device=device)
        if counters is None or counters.numel() < n_counters:
            counters = torch.zeros(n_counters, dtype=torch.int32,
                                   device=device)
        _scratch[key] = (ws, counters)
    return ws, counters


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
    token just written). Returns [B, Hq, D]. The kernel has no backward:
    with grad mode on, an input that requires grad raises RuntimeError
    rather than giving a result cut from the graph."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError(
            "decode attention has no gradient: the CUDA decode kernel has "
            "no backward, so its output would be cut from the autograd "
            "graph; call it under torch.no_grad() or with inputs that do "
            "not require grad")
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
    if not supported_head_dim(d):
        raise ValueError(
            f"decode attention kernel takes head dims that are "
            f"{HEAD_DIM_RULE}; got D={d} for q {tuple(q.shape)}")
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
    plan = split_plan(b, hq, kv, s, d, q.element_size())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws, counters = _workspace(
            q.device, stream,
            plan.items * plan.n_splits * plan.group * (d + 2), plan.items)
        kernels.DECODE_ATTENTION.launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), b, hq, kv, s, d, code, plan.group,
            plan.chunk, plan.n_splits, stream, head_dim=d)
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """q [B, Hq, D]; caches [B, S, KV, D]; lengths [B] -> [B, Hq, D].
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if q.device.type == "cpu":
        return _reference_decode_attention(q, k_cache, v_cache, lengths)
    return decode_attention_cuda(q, k_cache, v_cache, lengths)

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
from the shapes and the card's SM count alone (never from the lengths),
and the wrapper hands the kernel a workspace for the partial results and a
buffer of zeroed int counters, both kept per device and stream. The kernel
merges the partials in the same launch, through a tree of two levels
(groups of MERGE_FANIN chunks, then the groups), and leaves the counters
at zero, so a CUDA graph can capture the call.

Head dims: every multiple of 8 from 8 to 256 (the JAX package's Pallas
kernel takes any D). 8, 16, 32, 64, 80, 96, 128 and 256 are tiles of
their own; any other D runs on the tile above it (`decode_tile`), whose
lanes past D read nothing. Outside the rule the wrapper raises a
ValueError that states it.

Counterpart: ray_tpu/ops/decode_attention.py (`decode_attention_pallas`,
`_xla_decode_attention`, `decode_attention`).
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.kernels import HEAD_DIM_RULE, supported_head_dim

# Tiles the kernel is built for (decode_attention.cu, by_width).
TILES = (8, 16, 32, 64, 80, 96, 128, 256)
# Query heads one block serves at most (a KV head with more takes several
# blocks): the tensor cores' N in bf16, the CUDA cores' largest instance in
# f32.
MAX_GROUP = 8
# Chunks whose partials one block merges at the first level of the merge
# tree (decode_attention.cu, kMergeFanIn).
MERGE_FANIN = 16
# Blocks the grid should hold when every sequence fills the cache, per SM
# of the card (on an H100, chip_decode_probe.py --plans: 4 beat 8 to 32 at
# the serving widths). Longer caches get longer chunks rather than more
# blocks.
BLOCKS_PER_SM = 4
# A chunk holds at least this many stages, and, while the grid keeps a
# block per SM, at least MIN_CHUNK_ROWS rows: below that a block's fixed
# costs (its first copy's latency, the partial it writes and the merge
# reads) outweigh its rows.
MIN_STAGES = 2
MIN_CHUNK_ROWS = 128


def decode_tile(d: int) -> int:
    """The kernel's tile width for head dim d: d itself at 8, 16, 32, 64,
    80, 96, 128 and 256, else the power of two above it
    (decode_attention.cu, by_width)."""
    return next(t for t in TILES if t >= d and (t not in (80, 96) or t == d))


def stage_rows(d: int, elem_bytes: int, group: int) -> int:
    """Cache rows of one stage of the kernel's ring at the tile width, 16
    to 64: about 2 KB of K on CUDA cores up to the tile of 64 and 8 KB
    above it, 16 KB on tensor cores (bf16 groups of 2 to 8 query heads)
    below the tile of 256 and 8 KB at it (decode_attention.cu,
    stage_budget and stage_rows)."""
    tile = decode_tile(d)
    if elem_bytes == 2 and group > 1:
        budget = 16384 if tile < 256 else 8192
    else:
        budget = 2048 if tile <= 64 else 8192
    per = budget // (tile * elem_bytes)
    return 64 if per >= 64 else 32 if per >= 32 else 16


class SplitPlan(NamedTuple):
    """How the kernel cuts one call: `group` query heads per block,
    `n_groups` blocks across a KV head's heads, `items` = B * KV * n_groups
    merge targets, cache chunks of `chunk` rows and `n_splits` of them
    (n_splits * chunk >= S), merged in `merge_groups` groups of
    MERGE_FANIN. A block (item, split) reads rows [split * chunk,
    min((split + 1) * chunk, len)) and is active when that range is not
    empty, so ceil(len / chunk) blocks of an item are."""
    group: int
    n_groups: int
    items: int
    chunk: int
    n_splits: int
    merge_groups: int


@functools.lru_cache(maxsize=256)
def split_plan(b: int, hq: int, kv: int, s: int, d: int, elem_bytes: int,
               sms: int = 132) -> SplitPlan:
    """Whole stages per chunk: at least MIN_STAGES of them, at least
    MIN_CHUNK_ROWS rows while the grid keeps a block per SM, and about
    BLOCKS_PER_SM blocks per SM for a full cache, in chunks of equal
    length. At the serving width (B8, KV16, S1024, D64, bf16) on 132 SMs
    that is 256-row chunks and 4 splits: 320 active blocks on the smoke
    run's ragged lengths. One sequence of 32,768 rows, 8 query heads on one
    KV head, gets 256 chunks of 128 rows, merged in 16 groups of 16. The
    plan depends on the shapes alone, so a CUDA graph of the call stays
    valid for any lengths."""
    rep = hq // kv
    n_groups = -(-rep // MAX_GROUP)
    group = -(-rep // n_groups)
    items = b * kv * n_groups
    tile = stage_rows(d, elem_bytes, group)
    least = min(-(-MIN_CHUNK_ROWS // tile), max(1, s * items // (sms * tile)))
    stages = max(MIN_STAGES, least,
                 -(-s * items // (BLOCKS_PER_SM * sms * tile)),
                 -(-s // (65535 * tile)))  # the grid's y limit
    n_splits = max(1, -(-s // (tile * stages)))
    chunk = tile * max(1, -(-s // (n_splits * tile)))  # the same, equal
    n_splits = max(1, -(-s // chunk))
    return SplitPlan(group, n_groups, items, chunk, n_splits,
                     -(-n_splits // MERGE_FANIN))


_sms: dict = {}


def _sm_count(device) -> int:
    """The card's SM count, read once per device."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


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
    plan = split_plan(b, hq, kv, s, d, q.element_size(), _sm_count(q.device))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws, counters = _workspace(
            q.device, stream,
            plan.items * (plan.n_splits + plan.merge_groups) * plan.group
            * (d + 2), plan.items * (plan.merge_groups + 1))
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

"""The port's attention ops against the JAX package's, on the CPU.

On a CPU tensor each of the port's wrappers runs its plain version; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_ops.py does)
and its XLA reference paths. Inputs come from numpy with a fixed seed. All
comparisons are float32 within 2e-5: both sides keep softmax state in f32
and differ only in summation order. The TPU kernels need a cache length and
Sk that are multiples of 128 and an Sq that is a multiple of 8, so the
shared cases use those; the port's own rules beyond them (any length, zero
rows) are tested on the port alone.

Gradients: the JAX package's Pallas kernel has no gradient rule, so the
port's plain backward and its autograd Function are held to `jax.vjp` of
`_xla_attention` in f32 within 1e-5 (both differentiate the same math; only
the summation order differs).
"""

import ctypes
import itertools
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops.attention import _xla_attention
from ray_tpu.ops.decode_attention import (_xla_decode_attention,
                                          decode_attention_pallas)
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops import (decode_attention, dot_product_attention,
                               flash_attention)
from ray_tpu_torch.ops.attention import _reference_attention
from ray_tpu_torch.ops.decode_attention import (MERGE_FANIN, TILES,
                                                decode_attention_cuda,
                                                split_plan, stage_rows)
from ray_tpu_torch.ops.flash_attention import (
    BWD_TILES, _FlashAttention, _reference_flash_attention_backward,
    _reference_flash_attention_lse, bwd_head_split, flash_attention_backward_cuda,
    flash_attention_cuda, kernel_tile)

TOL = 2e-5


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


@pytest.mark.parametrize("b,hq,kv,d,s,lengths", [
    (3, 4, 4, 64, 256, [1, 100, 256]),   # MHA, ragged, full cache row
    (2, 8, 2, 128, 128, [1, 77]),        # GQA rep 4, D=128
    (2, 16, 16, 64, 128, [128, 5]),      # serving head layout
])
def test_decode_attention_matches_jax(b, hq, kv, d, s, lengths):
    rng = np.random.RandomState(0)
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, s, kv, d), \
        _randn(rng, b, s, kv, d)
    lens = np.asarray(lengths, np.int32)
    port = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens))
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    pallas = decode_attention_pallas(jq, jk, jv, jl, block_k=128,
                                     interpret=True)
    _close(port, pallas)
    _close(port, _xla_decode_attention(jq, jk, jv, jl))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 256, 256, 4, 4, 64),
    (1, 128, 384, 8, 2, 64),     # GQA, Sq < Sk (diagonal offset 256)
    (1, 128, 128, 2, 2, 128),
])
def test_flash_attention_matches_jax(b, sq, sk, hq, hkv, d, causal):
    rng = np.random.RandomState(1)
    q, k, v = _randn(rng, b, sq, hq, d), _randn(rng, b, sk, hkv, d), \
        _randn(rng, b, sk, hkv, d)
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(port, jax_flash(jq, jk, jv, causal=causal, block_q=128,
                           block_k=128, interpret=True))
    _close(port, _xla_attention(jq, jk, jv, causal=causal))
    port_dpa = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    _close(port_dpa, _xla_attention(jq, jk, jv, causal=causal))


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 130), (192, 128)])
def test_reference_attention_matches_xla_any_shape(sq, sk):
    """`_reference_attention` is the XLA path, Sq > Sk included (rows that
    see no key are the mean of V there); no tile rule applies."""
    rng = np.random.RandomState(2)
    q, k, v = _randn(rng, 1, sq, 4, 64), _randn(rng, 1, sk, 2, 64), \
        _randn(rng, 1, sk, 2, 64)
    port = _reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    _close(port, _xla_attention(*map(jnp.asarray, (q, k, v)), causal=True))


def test_flash_rows_without_keys_are_zero():
    """The port's rule for causal Sq > Sk: rows that see no key are zeros;
    the other rows equal the XLA path."""
    rng = np.random.RandomState(3)
    q, k, v = _randn(rng, 1, 192, 2, 64), _randn(rng, 1, 128, 2, 64), \
        _randn(rng, 1, 128, 2, 64)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True).numpy()
    assert np.all(out[:, :64] == 0)
    ref = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=True))
    _close(out[:, 64:], ref[:, 64:])


def test_decode_attention_any_cache_length():
    """No %128 rule in the port: S=100, lengths within it, against the
    dense XLA reference."""
    rng = np.random.RandomState(4)
    q, k, v = _randn(rng, 2, 4, 64), _randn(rng, 2, 100, 2, 64), \
        _randn(rng, 2, 100, 2, 64)
    lens = np.asarray([3, 100], np.int32)
    port = decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    _close(port, _xla_decode_attention(*map(jnp.asarray, (q, k, v, lens))))


SMOKE_RAGGED = [1, 1024, 517, 64, 300, 900, 128, 777]


@pytest.mark.parametrize("b,hq,kv,s,d,elem,lengths", [
    (8, 16, 16, 1024, 64, 2, SMOKE_RAGGED),        # serving shape
    (8, 16, 4, 1024, 64, 2, SMOKE_RAGGED),         # GQA rep 4
    (8, 16, 16, 1024, 64, 4, SMOKE_RAGGED),        # f32
    (4, 32, 2, 600, 128, 2, [1, 600, 333, 17]),    # rep 16, S % chunk != 0
    (3, 8, 8, 300, 128, 4, [0, 1, 299]),
    (2, 4, 1, 100000, 64, 2, [99999, 31]),         # long cache
    (1, 1, 1, 10 ** 7, 64, 2, [10 ** 7, 4097]),    # the grid's y limit
])
def test_split_plan_covers_every_row_once(b, hq, kv, s, d, elem, lengths):
    """The kernel's block (item, split) reads rows [split * chunk,
    min((split + 1) * chunk, len)) and is active when that is not empty:
    every row below the length lies in exactly one active chunk, the
    active count is ceil(len / chunk), the merge tree's first level takes
    every active chunk once in groups of MERGE_FANIN (each group's ticket
    count its members) and its second level one partial per active group,
    and the grid reaches every row of the cache."""
    plan = split_plan(b, hq, kv, s, d, elem)
    rep = hq // kv
    assert 1 <= plan.group <= 8 and plan.group * plan.n_groups >= rep
    assert plan.group * (plan.n_groups - 1) < rep  # no empty head group
    assert plan.items == b * kv * plan.n_groups
    rows = stage_rows(d, elem, plan.group)
    assert plan.chunk % rows == 0 and plan.chunk >= 2 * rows
    assert plan.n_splits * plan.chunk >= s and plan.n_splits <= 65535
    assert (plan.n_splits - 1) * plan.chunk < s
    assert plan.merge_groups == -(-plan.n_splits // MERGE_FANIN)
    for length in lengths:
        hits = np.zeros(length, np.int64)
        active = []
        for split in range(plan.n_splits):
            lo, hi = split * plan.chunk, min((split + 1) * plan.chunk, length)
            if lo < length:
                active.append(split)
                hits[lo:hi] += 1
        assert np.all(hits == 1)
        n_active = -(-length // plan.chunk)
        assert len(active) == n_active
        groups = {}
        for split in active:
            groups.setdefault(split // MERGE_FANIN, []).append(split)
        assert len(groups) == -(-n_active // MERGE_FANIN)
        for grp, members in groups.items():
            assert len(members) == min(MERGE_FANIN,
                                       n_active - grp * MERGE_FANIN)


def _active_blocks(plan, lengths, b):
    """Blocks of the grid that have rows, at these lengths."""
    return plan.items // b * sum(-(-n // plan.chunk) for n in lengths)


def test_split_plan_fills_the_card_at_the_serving_shape():
    """At B8 KV16 S1024 D64 bf16 on 132 SMs the smoke run's ragged lengths
    give at least twice 132 active blocks (132 SMs on the H100)."""
    plan = split_plan(8, 16, 16, 1024, 64, 2, 132)
    assert (plan.chunk, plan.n_splits) == (256, 4)
    assert _active_blocks(plan, SMOKE_RAGGED, 8) >= 2 * 132


def test_split_plan_fills_the_card_at_long_context():
    """One sequence of 32,768 rows, 8 query heads on one KV head (one item):
    the chunks alone give at least one block per SM of 132, which a
    one-block merge of every split could not take, and the merge tree's
    first level reads at most MERGE_FANIN partials a block."""
    plan = split_plan(1, 8, 1, 32768, 64, 2, 132)
    assert plan.items == 1 and plan.group == 8
    assert _active_blocks(plan, [32768], 1) >= 132
    assert plan.merge_groups > 1 and plan.merge_groups <= MERGE_FANIN


def _merge(parts):
    """Partials (max, denominator, accumulator) per query head, merged as
    the kernel's mergers do: M = max m_i, l = sum l_i e^(m_i - M), acc =
    sum acc_i e^(m_i - M)."""
    big = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    w = [torch.exp(m - big) for m, _, _ in parts]
    den = sum(l * c for (_, l, _), c in zip(parts, w))
    num = sum(a * c[:, None] for (_, _, a), c in zip(parts, w))
    return big, den, num


def _split_k_mirror(q, k, v, lens, plan):
    """The kernel's arithmetic in plain torch: per active chunk of each
    sequence an f32 (max, denominator, accumulator) per query head; a
    sequence of one chunk is that chunk's; else the first level merges
    each group of MERGE_FANIN chunks into a partial (the output when there
    is one group), the second level the groups' partials."""
    b, hq, d = q.shape
    rep = hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    out = torch.zeros_like(q)
    for i in range(b):
        n = int(lens[i])
        parts = []
        for lo in range(0, n, plan.chunk):
            hi = min(lo + plan.chunk, n)
            s = torch.einsum("hd,thd->ht", q[i], k[i, lo:hi]) * d ** -0.5
            m = s.max(dim=1).values
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(1), torch.einsum("ht,thd->hd", p,
                                                    v[i, lo:hi])))
        if not parts:
            continue  # length 0: zeros
        groups = [_merge(parts[g:g + MERGE_FANIN])
                  for g in range(0, len(parts), MERGE_FANIN)]
        _, den, num = groups[0] if len(groups) == 1 else _merge(groups)
        out[i] = num / den[:, None]
    return out


@pytest.mark.parametrize("b,hq,kv,d,s,lengths", [
    (3, 4, 4, 64, 256, [1, 100, 256]),
    (2, 16, 1, 128, 384, [129, 384]),    # rep 16: two head groups
    (8, 16, 16, 64, 1024, SMOKE_RAGGED),  # serving shape, 8 splits
    (2, 8, 1, 64, 2304, [2300, 1000]),   # 18 chunks: two merge groups
    (2, 8, 1, 256, 256, [256, 130]),     # MQA, 8 query heads a block, D 256
])
def test_split_k_merge_matches_jax(b, hq, kv, d, s, lengths):
    """Partials and the merge tree over the plan's chunks equal the Pallas
    kernel (interpret mode) and the dense XLA path in f32 within 1e-5."""
    rng = np.random.RandomState(5)
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, s, kv, d), \
        _randn(rng, b, s, kv, d)
    lens = np.asarray(lengths, np.int32)
    plan = split_plan(b, hq, kv, s, d, 4)
    assert plan.n_splits > 1
    if s == 2304:
        assert -(-max(lengths) // plan.chunk) > MERGE_FANIN
    if d == 256:
        assert plan.group == 8 and plan.n_groups == 1
    mirror = _split_k_mirror(*map(torch.from_numpy, (q, k, v, lens)), plan)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    _close(mirror, decode_attention_pallas(jq, jk, jv, jl, block_k=128,
                                           interpret=True), tol=1e-5)
    _close(mirror, _xla_decode_attention(jq, jk, jv, jl), tol=1e-5)


def test_decode_plan_constants_match_the_kernel_source():
    """The wrapper's merge fan-in, tiles and stage rows are the kernel's
    (decode_attention.cu): the plan's chunks and the workspace it sizes
    follow them."""
    src = (kernels.CSRC / "decode_attention.cu").read_text()
    fanin = re.search(r"constexpr int kMergeFanIn = (\d+);", src)
    assert fanin and int(fanin.group(1)) == MERGE_FANIN
    tiles = {int(t) for t in re.findall(r"by_group<T, (\d+)>", src)}
    assert tuple(sorted(tiles)) == TILES
    assert "return GAP ? (DT < 256 ? 16384 : 8192) : (DT <= 64 ? 2048 : " \
        "8192);" in src
    assert "stage_budget<DT, GAP>() / (DT * ELEM) >= 64   ? 64" in src
    widths = (8, 16, 32, 64, 80, 96, 128, 256)
    assert [stage_rows(d, 2, 1) for d in widths] \
        == [64, 64, 32, 16, 32, 32, 32, 16]
    assert [stage_rows(d, 2, 8) for d in widths] \
        == [64, 64, 64, 64, 64, 64, 64, 16]
    assert [stage_rows(d, 4, 8) for d in widths] \
        == [64, 32, 16, 16, 16, 16, 16, 16]


def _c_entry_points():
    """{symbol: [parameter declarations]} of every `extern "C" int rt_*`
    entry point under ops/csrc."""
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (rt_\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


@pytest.mark.parametrize("kernel", (*kernels.KERNELS, kernels.WGMMA_PROBE),
                         ids=lambda k: k.name)
def test_kernel_argtypes_match_the_c_entry_point(kernel):
    """Each Kernel's ctypes argtypes follow its C signature: as many
    parameters, c_void_p for every pointer and c_int for every int. ctypes
    passes a pointer given as c_int as 32 bits and cuts it silently, which
    would only show on the card."""
    params = _c_entry_points()[kernel.symbol]
    assert len(kernel.argtypes) == len(params), params
    for decl, argtype in zip(params, kernel.argtypes):
        if "*" in decl:
            assert argtype is ctypes.c_void_p, decl
        else:
            assert re.fullmatch(r"int \w+", decl), decl
            assert argtype is ctypes.c_int, decl


def _dq_block_offset():
    """The bf16 kernel's tile-major dQ layout, read from its source
    (`dq_block_offset` in flash_attention_bwd.cu): a function of the row
    r < 64 and column c of a block."""
    src = (kernels.CSRC / "flash_attention_bwd.cu").read_text()
    body = re.search(r"constexpr int dq_block_offset\(int r, int c\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    return eval("lambda r, c: " + " ".join(body.split()).replace(" / ", " // "))


def _dq_accum_index(b, hq, rows, d):
    """Index into the flat tile-major dQ accumulator (B Hq rows d floats:
    for each 64 rows, blocks of 64 columns, the last d - 64 cb wide) of
    each (b, h, row, column)."""
    off = _dq_block_offset()
    bi, h, i, c = np.meshgrid(np.arange(b), np.arange(hq), np.arange(rows),
                              np.arange(d), indexing="ij")
    idx = ((bi * hq + h) * rows + i - i % 64) * d + (c // 64) * 4096 \
        + off(i % 64, c % 64)
    assert sorted(idx.ravel().tolist()) == list(range(b * hq * rows * d))
    return torch.from_numpy(idx)


@pytest.mark.parametrize("w", [8, 16, 32, 40, 64])
def test_dq_accumulator_layout_is_a_block_permutation(w):
    """The first W columns of a block of the tile-major dQ accumulator are a
    permutation of its first 64 W floats (so a block cut at the head dim
    is one contiguous span), in the order a warpgroup's wgmma accumulator
    holds it (pair p of thread tid at 256 p + 2 tid), and 8 columns from a
    multiple of 8 lie in 8 consecutive floats (the convert's two 16-byte
    loads)."""
    off = _dq_block_offset()
    r, c = np.meshgrid(np.arange(64), np.arange(w), indexing="ij")
    flat = off(r, c)
    assert sorted(flat.ravel().tolist()) == list(range(64 * w))
    for tid in range(128):  # warp tid // 32, lane 4 g + t
        wp, g, t = tid // 32, tid % 32 // 4, tid % 4
        for reg in range(w // 2):  # 4 j + 2 hh + e
            j, hh, e = reg // 4, reg // 2 % 2, reg % 2
            row, col = 16 * wp + g + 8 * hh, 8 * j + 2 * t + e
            assert off(row, col) == reg // 2 * 256 + 2 * tid + e
    starts = flat[:, ::8]
    assert np.array_equal(flat.reshape(64, w // 8, 8) - starts[..., None],
                          np.broadcast_to(np.arange(8), (64, w // 8, 8)))


def _flash_backward_mirror(q, k, v, out, dout, lse, causal, hsplit=1):
    """The bf16 backward kernel's schedule in plain torch: one block per
    (share of a KV head's query heads, KV head, batch, key tile) walks its
    share's hsplit-th of the query heads and, for each, the query tiles
    from the first that sees its first key; per tile pair S^T,
    P^T = exp2(S^T scale log2 e - lse log2 e), dP^T and dS^T (P and dS
    rounded to q's dtype as the kernel's operands are), dV and dK summed in
    the block and written to its share's slot, the slots summed in order;
    dQ summed across blocks into the tile-major f32 accumulator
    (`_dq_accum_index`) of padded rows and read back out of it; dq, dk, dv
    cast once. Rows and keys past the tensors are zeros, as TMA fills them;
    rows past Sq or without a visible key have lse +inf."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep, off, scale = hq // hkv, sk - sq, d ** -0.5
    rep_blk = rep // hsplit
    block_k, block_q = BWD_TILES[d]
    rows = -(-sq // block_q) * block_q
    log2e = float(np.log2(np.e))

    def pad(t, n, value=0.0):  # along dim 1
        fill = t.new_full((t.shape[0], n - t.shape[1], *t.shape[2:]), value)
        return torch.cat([t, fill], dim=1)

    def rounded(t):
        return t.to(q.dtype).float()

    qp, dop = pad(q.float(), rows), pad(dout.float(), rows)
    kp = pad(k.float(), -(-sk // block_k) * block_k)
    vp = pad(v.float(), kp.shape[1])
    delta = pad(torch.einsum("bqhd,bqhd->bhq", dout.float(),
                             out.float()).transpose(1, 2), rows).transpose(1, 2)
    lse2 = torch.where(torch.isfinite(lse), lse * log2e, float("inf"))
    lse2 = pad(lse2.transpose(1, 2), rows, float("inf")).transpose(1, 2)
    acc_index = _dq_accum_index(b, hq, rows, d)
    dq_acc = torch.zeros(b * hq * rows * d)
    slots = torch.zeros(hsplit, 2, b, sk, hkv, d)
    for share, bi, hk, k0 in itertools.product(
            range(hsplit), range(b), range(hkv), range(0, sk, block_k)):
        kt, vt = kp[bi, k0:k0 + block_k, hk], vp[bi, k0:k0 + block_k, hk]
        key = torch.arange(k0, k0 + block_k)[:, None]
        dk_t, dv_t = torch.zeros(block_k, d), torch.zeros(block_k, d)
        first = max(0, k0 - off) // block_q * block_q if causal else 0
        heads = range(hk * rep + share * rep_blk,
                      hk * rep + (share + 1) * rep_blk)
        for h, q0 in itertools.product(heads, range(first, rows, block_q)):
            tile = slice(q0, q0 + block_q)
            qt, dot = qp[bi, tile, h], dop[bi, tile, h]
            hidden = (key >= sk).expand(block_k, block_q)
            if causal:
                hidden = hidden | (key > torch.arange(q0, q0 + block_q) + off)
            s_t = (kt @ qt.T).masked_fill(hidden, float("-inf"))
            p_t = torch.exp2(s_t * (scale * log2e) - lse2[bi, h, tile])
            ds_t = p_t * (vt @ dot.T - delta[bi, h, tile])
            p_t, ds_t = rounded(p_t), rounded(ds_t)
            dv_t += p_t @ dot
            dk_t += ds_t @ qt
            dq_acc.index_add_(0, acc_index[bi, h, tile].reshape(-1),
                              (ds_t.T @ kt).reshape(-1))
        n = min(block_k, sk - k0)
        slots[share, 0, bi, k0:k0 + n, hk] = dk_t[:n] * scale
        slots[share, 1, bi, k0:k0 + n, hk] = dv_t[:n]
    dkv = slots[0].clone()
    for share in range(1, hsplit):  # the convert's fixed order
        dkv += slots[share]
    dq = (dq_acc[acc_index[:, :, :sq]] * scale).transpose(1, 2)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (1, 200, 200, 8, 2, 64, True),     # GQA rep 4, two tiles each way
    (1, 100, 300, 4, 2, 64, True),     # Sq < Sk (diagonal offset 200)
    (2, 129, 129, 2, 1, 64, True),     # ragged: one key and one row past a tile
    (1, 60, 255, 2, 2, 64, False),     # ragged Sk = 255
    (1, 150, 150, 4, 1, 128, True),    # D=128: 64-row query tiles, rep 4
    (1, 100, 140, 4, 2, 40, True),     # runtime width in the tile of 64
])
def test_flash_backward_schedule_matches_jax(b, sq, sk, hq, hkv, d, causal):
    """The kernel's block schedule (tiles from BWD_TILES, the head split
    bwd_head_split picks for an H100's 132 multiprocessors, > 1 at the
    GQA cases), mirrored in plain torch, equals jax.vjp of `_xla_attention`
    and the plain backward in f32 within 1e-5."""
    rng = np.random.RandomState(10)
    q, dout = _randn(rng, b, sq, hq, d), _randn(rng, b, sq, hq, d)
    k, v = _randn(rng, b, sk, hkv, d), _randn(rng, b, sk, hkv, d)
    _, ref = _jax_attention_vjp(q, k, v, dout, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, causal)
    hsplit = bwd_head_split(b, sk, hq, hkv, d, 132)
    assert (hsplit > 1) == (hq > hkv)
    mirror = _flash_backward_mirror(tq, tk, tv, out, tdo, lse, causal, hsplit)
    plain = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                causal)
    for g, p, r in zip(mirror, plain, ref):
        _close(g, r, tol=1e-5)
        _close(g, p, tol=1e-5)


def test_flash_backward_schedule_rows_without_keys():
    """Causal Sq > Sk: the mirror equals the plain backward (the reference's
    two paths disagree on rows without keys), and those rows get dq = 0."""
    rng = np.random.RandomState(11)
    q, dout = _randn(rng, 1, 300, 4, 64), _randn(rng, 1, 300, 4, 64)
    k, v = _randn(rng, 1, 200, 2, 64), _randn(rng, 1, 200, 2, 64)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, True)
    mirror = _flash_backward_mirror(tq, tk, tv, out, tdo, lse, True)
    plain = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                True)
    assert torch.all(mirror[0][:, :100] == 0)
    for g, p in zip(mirror, plain):
        assert torch.isfinite(g).all()
        _close(g, p, tol=1e-5)


def _flash_backward_f32_mirror(q, k, v, out, dout, lse, causal):
    """The f32 backward kernel's tiling in plain torch (flash_attention_bwd.cu,
    f32 path): 32-row query tiles and key tiles of 32 keys (16 at the tile
    of 256); KV blocks (key tile, KV head, batch) whose groups (4 at tiles
    up to 64, 2 at 128, 1 at 256) take the block's (query head, query tile)
    items in turn, group g the items g, g + G, ..., and Q blocks (query tile,
    query head, batch) whose groups take its key tiles the same way; each
    recomputes P and dS of its tile pairs; the groups' sums are added in
    group order; no sum crosses blocks."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep, off, scale = hq // hkv, sk - sq, d ** -0.5
    dt = kernel_tile(d)
    kk, rows = (16 if dt == 256 else 32), 32
    groups = 4 if dt <= 64 else 2 if dt == 128 else 1
    nq, nk = -(-sq // rows), -(-sk // kk)

    def pad(t, n):  # along dim 1
        return torch.cat([t, t.new_zeros(t.shape[0], n - t.shape[1],
                                          *t.shape[2:])], dim=1)

    qp, dop = pad(q, nq * rows), pad(dout, nq * rows)
    kp, vp = pad(k, nk * kk), pad(v, nk * kk)
    delta = torch.einsum("bqhd,bqhd->bhq", dout, out)
    lse_p = pad(lse.transpose(1, 2), nq * rows).transpose(1, 2)
    delta_p = pad(delta.transpose(1, 2), nq * rows).transpose(1, 2)

    def pair(bi, h, q0, k0):
        qt, dot = qp[bi, q0:q0 + rows, h], dop[bi, q0:q0 + rows, h]
        kt, vt = kp[bi, k0:k0 + kk, h // rep], vp[bi, k0:k0 + kk, h // rep]
        i = torch.arange(q0, q0 + rows)[:, None]
        j = torch.arange(k0, k0 + kk)[None]
        lse_i = lse_p[bi, h, q0:q0 + rows, None]
        vis = (i < sq) & (j < sk) & torch.isfinite(lse_i)
        if causal:
            vis = vis & (j <= i + off)
        p = torch.where(vis, torch.exp((qt @ kt.T) * scale - lse_i), 0.0)
        ds = p * (dot @ vt.T - delta_p[bi, h, q0:q0 + rows, None])
        return p, ds, qt, dot, kt

    def in_group_order(items, step):
        parts = []
        for g in range(groups):
            part = None
            for item in items[g::groups]:
                term = step(item)
                part = term if part is None else tuple(
                    a + t for a, t in zip(part, term))
            parts.append(part)
        total = None
        for part in parts:
            if part is not None:
                total = part if total is None else tuple(
                    a + t for a, t in zip(total, part))
        return total

    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for kt_i, bi, hk in itertools.product(range(nk), range(b), range(hkv)):
        k0 = kt_i * kk
        first = max(0, k0 - off) // rows if causal else 0
        items = [(h, m) for h in range(hk * rep, (hk + 1) * rep)
                 for m in range(first, nq)]

        def kv_step(item, k0=k0, bi=bi):
            p, ds, qt, dot, _ = pair(bi, item[0], item[1] * rows, k0)
            return ds.T @ qt, p.T @ dot

        total = in_group_order(items, kv_step)
        n = min(kk, sk - k0)
        if total is not None:
            dk[bi, k0:k0 + n, hk] = total[0][:n] * scale
            dv[bi, k0:k0 + n, hk] = total[1][:n]
    for qt_i, bi, h in itertools.product(range(nq), range(b), range(hq)):
        q0 = qt_i * rows
        k_end = max(0, min(sk, min(q0 + rows, sq) + off)) if causal else sk

        def q_step(n, q0=q0, bi=bi, h=h):
            _, ds, _, _, kt = pair(bi, h, q0, n * kk)
            return (ds @ kt,)

        total = in_group_order(list(range(-(-k_end // kk))), q_step)
        n = min(rows, sq - q0)
        if total is not None:
            dq[bi, q0:q0 + n, h] = total[0][:n] * scale
    return dq, dk, dv


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (1, 256, 256, 4, 4, 64, True),     # phase 2's f32 row, at its shape
    (2, 130, 130, 4, 4, 8, True),      # D=8 (the tile of 16), ragged
    (2, 32, 32, 4, 4, 16, True),       # the dryrun's D=16, one tile pair
    (1, 70, 150, 4, 2, 16, True),      # GQA, Sq < Sk
    (1, 100, 100, 8, 1, 64, False),    # MQA rep 8: two groups per head
])
def test_flash_backward_f32_tiling_matches_jax(b, sq, sk, hq, hkv, d, causal):
    """The f32 kernel's tiling (KV and Q blocks, groups taking tiles in
    turn, sums in group order), mirrored in plain torch, equals jax.vjp of
    `_xla_attention` and the plain backward within 1e-5."""
    rng = np.random.RandomState(12)
    q, dout = _randn(rng, b, sq, hq, d), _randn(rng, b, sq, hq, d)
    k, v = _randn(rng, b, sk, hkv, d), _randn(rng, b, sk, hkv, d)
    _, ref = _jax_attention_vjp(q, k, v, dout, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, causal)
    mirror = _flash_backward_f32_mirror(tq, tk, tv, out, tdo, lse, causal)
    plain = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                causal)
    for g, p, r in zip(mirror, plain, ref):
        _close(g, r, tol=1e-5)
        _close(g, p, tol=1e-5)


def test_flash_backward_f32_tiling_rows_without_keys():
    """Causal Sq > Sk in the f32 tiling: rows without a key get dq = 0 and
    the rest equals the plain backward."""
    rng = np.random.RandomState(13)
    q, dout = _randn(rng, 1, 90, 2, 16), _randn(rng, 1, 90, 2, 16)
    k, v = _randn(rng, 1, 40, 2, 16), _randn(rng, 1, 40, 2, 16)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, True)
    mirror = _flash_backward_f32_mirror(tq, tk, tv, out, tdo, lse, True)
    plain = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                True)
    assert torch.all(mirror[0][:, :50] == 0)
    for g, p in zip(mirror, plain):
        _close(g, p, tol=1e-5)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers raise ValueError naming the shape for head dims
    outside the rule (multiples of 8 from 8 to 256), and refuse CPU tensors
    rather than computing, at D = 96 as at 64."""
    z = torch.zeros
    with pytest.raises(ValueError, match="D=100"):
        decode_attention_cuda(z(1, 2, 100), z(1, 8, 2, 100),
                              z(1, 8, 2, 100), z(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="D=100"):
        flash_attention_cuda(z(1, 8, 2, 100), z(1, 8, 2, 100),
                             z(1, 8, 2, 100))
    for d in (64, 96):
        with pytest.raises(ValueError, match="CUDA"):
            decode_attention_cuda(z(1, 2, d), z(1, 8, 2, d), z(1, 8, 2, d),
                                  z(1, dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(z(1, 8, 2, d), z(1, 8, 2, d),
                                 z(1, 8, 2, d))


def test_cuda_entry_points_raise_without_cuda():
    """Asked for "cuda" where there is none, the entry points raise instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import ContinuousEngine
    from ray_tpu_torch.llm.openai import OpenAIServer
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)

    cfg = LLMConfig(vocab_size=300, d_model=64, n_layers=1, n_heads=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(TransformerConfig(vocab_size=16, d_model=64, n_layers=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OpenAIServer(cfg)


def _jax_attention_vjp(q, k, v, dout, causal):
    """(out, (dq, dk, dv)) of the JAX package's XLA attention."""
    out, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, causal=causal),
                       *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(dout))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 64, 64, 4, 4, 64, True),
    (2, 64, 64, 4, 4, 64, False),
    (1, 48, 128, 8, 2, 64, True),      # GQA, Sq < Sk (diagonal offset 80)
    (1, 100, 100, 4, 1, 128, True),    # ragged, GQA rep 4, D=128
    (1, 37, 130, 4, 2, 64, False),     # ragged, Sq < Sk
])
def test_flash_backward_matches_jax_grad(b, sq, sk, hq, hkv, d, causal):
    """The plain backward (from lse and Delta) and the CPU autograd
    Function both equal jax.vjp of `_xla_attention` within 1e-5."""
    rng = np.random.RandomState(6)
    q, dout = _randn(rng, b, sq, hq, d), _randn(rng, b, sq, hq, d)
    k, v = _randn(rng, b, sk, hkv, d), _randn(rng, b, sk, hkv, d)
    _, ref = _jax_attention_vjp(q, k, v, dout, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, causal)
    plain = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fout = flash_attention(*leaves, causal=causal)
    assert fout.grad_fn is not None
    fout.backward(tdo)
    for g, fn_leaf, r in zip(plain, leaves, ref):
        _close(g, r, tol=1e-5)
        _close(fn_leaf.grad, r, tol=1e-5)


def test_flash_backward_rows_without_keys():
    """Causal Sq > Sk: rows that see no key get dq = 0 and add nothing to
    dk/dv, with no NaN; the rest equals jax.vjp of `_xla_attention` with
    those rows' incoming gradient set to zero (the XLA path gives them the
    mean of V, which the port does not)."""
    rng = np.random.RandomState(7)
    q, dout = _randn(rng, 1, 192, 4, 64), _randn(rng, 1, 192, 4, 64)
    k, v = _randn(rng, 1, 128, 2, 64), _randn(rng, 1, 128, 2, 64)
    live = dout.copy()
    live[:, :64] = 0
    _, ref = _jax_attention_vjp(q, k, v, live, True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, True)
    assert torch.isinf(lse[..., :64]).all() and torch.isfinite(lse[..., 64:]).all()
    grads = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                True)
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.all(grads[0][:, :64] == 0)
    for g, r in zip(grads, ref):
        _close(g, r, tol=1e-5)


@pytest.mark.parametrize("sq,sk,hq,hkv,causal", [
    (12, 9, 4, 2, True),    # Sq > Sk: three rows without keys
    (9, 12, 2, 1, True),    # Sq < Sk, GQA rep 2
    (10, 10, 2, 2, False),
])
def test_flash_attention_function_gradcheck(sq, sk, hq, hkv, causal):
    """torch.autograd.gradcheck of the CPU `_FlashAttention` in float64:
    its backward (the plain backward) against finite differences of its
    forward."""
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(1, s, h, 16, dtype=torch.float64, generator=gen,
                           requires_grad=True)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: _FlashAttention.apply(a, b, c, causal), (q, k, v))


def test_flash_attention_takes_the_function_only_for_grad(monkeypatch):
    """Under torch.no_grad(), or with no input requiring grad, the call is
    the plain forward (no Function, nothing saved); with grad it is the
    Function."""
    def refuse(*args):
        raise AssertionError("the autograd Function ran")

    rng = np.random.RandomState(9)
    q = torch.from_numpy(_randn(rng, 1, 16, 2, 64)).requires_grad_()
    k = torch.from_numpy(_randn(rng, 1, 16, 2, 64))
    with monkeypatch.context() as m:
        m.setattr(_FlashAttention, "apply", staticmethod(refuse))
        with torch.no_grad():
            assert flash_attention(q, k, k).grad_fn is None
        assert flash_attention(q.detach(), k, k).grad_fn is None
    assert flash_attention(q, k, k).grad_fn is not None


def test_backward_and_decode_wrappers_refuse_what_the_kernels_do_not_take():
    """The backward wrapper checks shapes, head dims and devices as the
    forward's does; the decode wrapper refuses inputs that require grad
    (the kernel has no backward) before anything else."""
    z = torch.zeros
    q, k = z(1, 8, 2, 64), z(1, 8, 2, 64)
    lse = z(1, 2, 8)
    with pytest.raises(ValueError, match="D=100"):
        flash_attention_backward_cuda(*(z(1, 8, 2, 100) for _ in range(5)),
                                      lse)
    with pytest.raises(ValueError, match="shaped like q"):
        flash_attention_backward_cuda(q, k, k, q, z(1, 7, 2, 64), lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_backward_cuda(q, k, k, q, q, lse)
    dq = z(1, 2, 64, requires_grad=True)
    cache = z(1, 8, 2, 64)
    lens = z(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention_cuda(dq, cache, cache, lens)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(dq, cache, cache, lens)

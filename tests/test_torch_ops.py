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
    _reference_flash_attention_lse, flash_attention_backward_cuda,
    flash_attention_cuda)

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


def _flash_backward_mirror(q, k, v, out, dout, lse, causal):
    """The bf16 backward kernel's schedule in plain torch: one block per
    (key tile, KV head, batch) walks the KV head's query heads and, for
    each, the query tiles from the first that sees its first key; per tile
    pair S^T, P^T = exp2(S^T scale log2 e - lse log2 e), dP^T and dS^T (P
    and dS rounded to q's dtype as the kernel's operands are), dV and dK
    summed in the block, dQ summed across blocks in an f32 accumulator of
    padded rows; dq, dk, dv cast once. Rows and keys past the tensors are
    zeros, as TMA fills them; rows past Sq or without a visible key have
    lse +inf."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep, off, scale = hq // hkv, sk - sq, d ** -0.5
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
    dq_acc = torch.zeros(b, hq, rows, d)
    dk, dv = torch.zeros(b, sk, hkv, d), torch.zeros(b, sk, hkv, d)
    for bi, hk, k0 in itertools.product(range(b), range(hkv),
                                        range(0, sk, block_k)):
        kt, vt = kp[bi, k0:k0 + block_k, hk], vp[bi, k0:k0 + block_k, hk]
        key = torch.arange(k0, k0 + block_k)[:, None]
        dk_t, dv_t = torch.zeros(block_k, d), torch.zeros(block_k, d)
        first = max(0, k0 - off) // block_q * block_q if causal else 0
        for h, q0 in itertools.product(range(hk * rep, (hk + 1) * rep),
                                       range(first, rows, block_q)):
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
            dq_acc[bi, h, tile] += ds_t.T @ kt
        n = min(block_k, sk - k0)
        dk[bi, k0:k0 + n, hk] = dk_t[:n] * scale
        dv[bi, k0:k0 + n, hk] = dv_t[:n]
    dq = (dq_acc[:, :, :sq] * scale).transpose(1, 2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (1, 200, 200, 8, 2, 64, True),     # GQA rep 4, two tiles each way
    (1, 100, 300, 4, 2, 64, True),     # Sq < Sk (diagonal offset 200)
    (2, 129, 129, 2, 1, 64, True),     # ragged: one key and one row past a tile
    (1, 60, 255, 2, 2, 64, False),     # ragged Sk = 255
    (1, 150, 150, 4, 1, 128, True),    # D=128: 64-row query tiles, rep 4
])
def test_flash_backward_schedule_matches_jax(b, sq, sk, hq, hkv, d, causal):
    """The kernel's block schedule (tiles from BWD_TILES), mirrored in plain
    torch, equals jax.vjp of `_xla_attention` and the plain backward in f32
    within 1e-5."""
    rng = np.random.RandomState(10)
    q, dout = _randn(rng, b, sq, hq, d), _randn(rng, b, sq, hq, d)
    k, v = _randn(rng, b, sk, hkv, d), _randn(rng, b, sk, hkv, d)
    _, ref = _jax_attention_vjp(q, k, v, dout, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, causal)
    mirror = _flash_backward_mirror(tq, tk, tv, out, tdo, lse, causal)
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

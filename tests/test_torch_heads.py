"""The port's attention at every head width the JAX package's kernels take,
on the CPU: its own narrow widths D = 16 and 32, D = 8, and the widths of
public models (80: Phi-2, 96: Phi-3-mini, 256: Gemma).

The plain versions of the three kernels against the JAX package (its
Pallas kernels in interpret mode, its XLA paths, `jax.vjp` of
`_xla_attention` for the gradient) in float32 within 1e-5, at the TPU
kernels' tile rules (Sq a multiple of 8, Sk and cache lengths multiples of
128); the decode kernel's split plan at these widths; the wrappers'
refusal of the widths no kernel takes (the rule: multiples of 8 from 8 to
256); and the port's dryrun at the reference's own configurations (heads
of 16). The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import ast
import importlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops.attention import _xla_attention
from ray_tpu.ops.decode_attention import (_xla_decode_attention,
                                          decode_attention_pallas)
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import decode_attention, flash_attention
from ray_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                split_plan, stage_rows)
from ray_tpu_torch.ops.flash_attention import (
    _reference_flash_attention_backward, _reference_flash_attention_lse,
    flash_attention_backward_cuda, flash_attention_cuda)
from ray_tpu_torch.parallel import dryrun

# the modules (ray_tpu_torch.ops re-exports their functions by these names)
decode_mod = importlib.import_module("ray_tpu_torch.ops.decode_attention")
flash_mod = importlib.import_module("ray_tpu_torch.ops.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


# The head dims of the parity tests; D = 256 runs at small B and S.
WIDTHS = [8, 16, 32, 80, 96, 256]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,hq,kv,s,lengths", [
    (3, 4, 4, 256, [1, 100, 256]),   # MHA, ragged, a full cache row
    (2, 8, 2, 128, [1, 77]),         # GQA rep 4
])
def test_decode_attention_matches_jax_at_narrow_heads(d, b, hq, kv, s,
                                                      lengths):
    rng = np.random.RandomState(0)
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, s, kv, d), \
        _randn(rng, b, s, kv, d)
    lens = np.asarray(lengths, np.int32)
    port = decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    _close(port, decode_attention_pallas(jq, jk, jv, jl, block_k=128,
                                         interpret=True))
    _close(port, _xla_decode_attention(jq, jk, jv, jl))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv", [
    (2, 128, 128, 4, 4),
    (1, 64, 256, 8, 2),   # GQA, Sq < Sk (diagonal offset 192)
])
def test_flash_attention_matches_jax_at_narrow_heads(d, causal, b, sq, sk,
                                                     hq, hkv):
    rng = np.random.RandomState(1)
    q, k, v = _randn(rng, b, sq, hq, d), _randn(rng, b, sk, hkv, d), \
        _randn(rng, b, sk, hkv, d)
    port = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(port, jax_flash(jq, jk, jv, causal=causal, block_q=min(sq, 128),
                           block_k=128, interpret=True))
    _close(port, _xla_attention(jq, jk, jv, causal=causal))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,hq,hkv,causal", [
    (2, 64, 128, 4, 4, True),
    (1, 32, 128, 8, 2, False),   # GQA, Sq < Sk
    (8, 32, 32, 8, 8, True),     # the dryrun's training heads (D = 16)
])
def test_flash_backward_matches_jax_grad_at_narrow_heads(d, b, sq, sk, hq,
                                                         hkv, causal):
    """The plain backward (from lse and Delta) and the CPU autograd
    Function both equal jax.vjp of `_xla_attention` within 1e-5."""
    rng = np.random.RandomState(6)
    q, dout = _randn(rng, b, sq, hq, d), _randn(rng, b, sq, hq, d)
    k, v = _randn(rng, b, sk, hkv, d), _randn(rng, b, sk, hkv, d)
    _, vjp = jax.vjp(lambda a, c, e: _xla_attention(a, c, e, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _reference_flash_attention_lse(tq, tk, tv, causal)
    plain = _reference_flash_attention_backward(tq, tk, tv, out, tdo, lse,
                                                causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    flash_attention(*leaves, causal=causal).backward(tdo)
    for g, leaf, r in zip(plain, leaves, ref):
        _close(g, r)
        _close(leaf.grad, r)


def _kernel_stage_rows(d: int, elem: int, group: int) -> int:
    """decode_attention.cu: the instance's tile DT is D at 8, 16, 32, 64,
    80, 96, 128 and 256, else the power of two above D (16 at least on
    tensor cores, which take bf16 groups of 2 to 8); a stage holds about
    2 KB of K at the tile width on CUDA cores up to the tile of 64 and 8 KB
    above it, 16 KB on tensor cores below the tile of 256 and 8 KB at it
    (stage_budget, stage_rows), 16 to 64 rows."""
    mma = elem == 2 and group > 1
    dt = d if d in (8, 16, 32, 64, 80, 96, 128, 256) \
        else 1 << (d - 1).bit_length()
    dt = max(dt, 16) if mma else dt
    budget = (16384 if dt < 256 else 8192) if mma else \
        (2048 if dt <= 64 else 8192)
    per = budget // (dt * elem)
    return 64 if per >= 64 else 32 if per >= 32 else 16


def _kernel_lanes(d: int, elem: int) -> tuple:
    """decode_attention.cu, Lanes<T, DT>: 16-byte slices of a tile row, the
    lanes one row takes (the largest power of two, at most 32, dividing the
    slices) and the slices each lane holds."""
    dt = d if d in (8, 16, 32, 64, 80, 96, 128, 256) \
        else 1 << (d - 1).bit_length()
    nsl = dt * elem // 16
    tpr = min(32, nsl & -nsl)
    return nsl, tpr, nsl // tpr


@pytest.mark.parametrize("d", [8, 16, 32, 80, 96, 120, 256])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("b,hq,kv,s,lengths", [
    (8, 16, 16, 1024, [1, 1024, 517, 64, 300, 900, 128, 777]),
    (8, 16, 4, 1024, [1, 1024, 517, 64, 300, 900, 128, 777]),
    (2, 4, 4, 64, [64, 1]),
    (8, 8, 1, 2048, [1, 2048, 1000, 17, 512, 1999, 64, 700]),  # group 8
])
def test_split_plan_at_narrow_heads(d, elem, b, hq, kv, s, lengths):
    """stage_rows is the kernel's rows per stage at every tile width (D = 8:
    64 rows of 16 bytes; D = 80 and 96: tiles of their own, whose rows take
    2 and 4 bf16 lanes with no lane past D; D = 256: 16 rows), a block
    serves up to 8 query heads at every width (D = 256 too), and the
    plan's chunks cover every row of every length once, in whole stages."""
    plan = split_plan(b, hq, kv, s, d, elem)
    rows = stage_rows(d, elem, plan.group)
    assert rows == _kernel_stage_rows(d, elem, plan.group)
    assert plan.chunk % rows == 0 and plan.n_splits * plan.chunk >= s
    assert plan.group == min(hq // kv, 8)
    # MIN_CHUNK_ROWS (128), while the grid keeps a block per SM of 132
    assert plan.chunk >= min(128, s) \
        or plan.items * -(-s // (plan.chunk + rows)) < 132
    for length in lengths:
        hits = np.zeros(length, np.int64)
        for split in range(plan.n_splits):
            hits[split * plan.chunk:min((split + 1) * plan.chunk,
                                        length)] += 1
        assert np.all(hits == 1)
    nsl, tpr, nv = _kernel_lanes(d, elem)
    if d in (80, 96):
        assert decode_mod.decode_tile(d) == d
        assert tpr * nv == nsl == d * elem // 16  # real width, no idle lane
        if elem == 2:
            assert (tpr, nv) == ((2, 5) if d == 80 else (4, 3))
    if d == 8 and elem == 2:
        assert rows == 64 and tpr == 1  # 1 KB of K a stage: 16 rows at least
    if d == 256:
        assert rows == 16


@pytest.mark.parametrize("b,sk,hq,hkv,d,want", [
    (2, 2048, 8, 1, 256, 4),    # Gemma's MQA: 64 key tiles x 4 = 256 blocks
    (1, 200, 8, 1, 256, 8),     # every query head its own block
    (2, 2048, 16, 16, 40, 1),   # enough KV heads already
    (2, 2048, 8, 1, 64, 8),     # an exact width: 32 blocks x 8 = 256
    (2, 2048, 32, 8, 96, 1),    # Phi-3-mini's width, GQA: 256 blocks already
    (4, 2048, 8, 1, 80, 4),     # Phi-2's width runs the tile of 128
    (2, 300, 8, 2, 8, 4),
    (2, 300, 8, 2, 16, 4),      # exact D16: 12 blocks, every query head its own
    (4, 1024, 16, 16, 32, 1),   # exact D32 at the training heads: 512 blocks
    (2, 1024, 16, 4, 128, 4),   # exact D128 GQA: 64 blocks x 4 = 256
    (2, 1024, 16, 4, 64, 4),    # phase 2's GQA row: 64 blocks x 4 = 256
])
def test_backward_head_split_fills_the_card(b, sk, hq, hkv, d, want):
    """bwd_head_split: the least divisor of Hq / Hkv that gives the bf16
    backward at least a block per multiprocessor (an H100's 132), or all of
    them, at every width."""
    sms = 132
    split = flash_mod.bwd_head_split(b, sk, hq, hkv, d, sms)
    assert split == want and (hq // hkv) % split == 0
    blocks = hkv * b * -(-sk // flash_mod.BWD_TILES[d][0])
    assert blocks * split >= sms or split == hq // hkv


@pytest.mark.parametrize("d", [12, 264])
def test_wrappers_name_the_supported_head_dims(d):
    """Each CUDA wrapper refuses a head dim outside the rule (a multiple of
    8 from 8 to 256) with a ValueError that states it (before looking at
    devices)."""
    assert decode_mod.HEAD_DIM_RULE == flash_mod.HEAD_DIM_RULE \
        == "a multiple of 8 from 8 to 256"
    assert all(decode_mod.supported_head_dim(w)
               and flash_mod.supported_head_dim(w)
               for w in range(8, 257, 8))
    assert not decode_mod.supported_head_dim(d)
    z = torch.zeros
    named = "a multiple of 8 from 8 to 256"
    with pytest.raises(ValueError, match=named):
        decode_attention_cuda(z(1, 2, d), z(1, 8, 2, d), z(1, 8, 2, d),
                              z(1, dtype=torch.int32))
    with pytest.raises(ValueError, match=named):
        flash_attention_cuda(z(1, 8, 2, d), z(1, 8, 2, d), z(1, 8, 2, d))
    with pytest.raises(ValueError, match=named):
        flash_attention_backward_cuda(*(z(1, 8, 2, d) for _ in range(5)),
                                      z(1, 2, 8))


def _reference_config_kwargs(call: str) -> dict:
    """The constant keyword arguments of the `call(...)` in
    __graft_entry__.py's dryrun_multichip."""
    tree = ast.parse(open(os.path.join(REPO, "__graft_entry__.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  getattr(node.func, "id",
                                                          None)) == call:
            return {kw.arg: kw.value.value for kw in node.keywords
                    if isinstance(kw.value, ast.Constant)}
    raise AssertionError(f"no {call}(...) in __graft_entry__.py")


def test_dryrun_runs_the_reference_configurations():
    """The port's dryrun_multichip(4) on the CPU: the training step's model
    and the tp generate's are the reference's (heads of 16), and every
    configuration runs within its tolerance on 4 ranks."""
    assert dryrun.TRAIN_CONFIG == {
        k: v for k, v in _reference_config_kwargs("TransformerConfig").items()
        if k in dryrun.TRAIN_CONFIG}
    assert set(dryrun.TRAIN_CONFIG) >= {"vocab_size", "d_model", "n_layers",
                                        "n_heads", "n_kv_heads", "d_ff",
                                        "max_seq"}
    assert dryrun.GENERATE_CONFIG == _reference_config_kwargs("LLMConfig")
    assert dryrun.TRAIN_CONFIG["d_model"] // dryrun.TRAIN_CONFIG["n_heads"] \
        == 16
    assert dryrun.GENERATE_CONFIG["d_model"] \
        // dryrun.GENERATE_CONFIG["n_heads"] == 16
    ranks = dryrun.dryrun_ranks(4, device="cpu")
    assert [label for label, _ in ranks[0]["runs"]] == [
        "dp.sp2.tp2", "fsdp2.tp2", "ep2.moe", "pp2.pipeline",
        "tp4.llm.generate"]
    losses = dict(ranks[0]["runs"][:4])
    assert all(np.isfinite(v) for v in losses.values())
    # the plain versions ran: no kernel launches on the CPU
    for r in ranks:
        assert all(not by_d for by_d in r["launches"].values())

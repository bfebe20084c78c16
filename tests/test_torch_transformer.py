"""The port's Transformer against the JAX package's, at JAX-initialised
weights carried across by `params_from_flax`, in float32 on the CPU.

Tolerance 2e-5 on logits of magnitude below ~1: both sides compute in f32
and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu_torch.llm.engine import stage_layer_split, stage_param_slice
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              _rope)

TOL = 2e-5
SHAPE = dict(vocab_size=320, d_model=128, n_layers=2, n_heads=4, d_ff=336,
             max_seq=64)


def _models(n_kv_heads, moe_experts=0):
    jcfg = JaxConfig(**SHAPE, n_kv_heads=n_kv_heads, dtype=jnp.float32,
                     moe_experts=moe_experts)
    jmodel = JaxTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(np.asarray, params)
    tcfg = TransformerConfig(**SHAPE, n_kv_heads=n_kv_heads,
                             dtype=torch.float32, moe_experts=moe_experts)
    tmodel = Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(tree))
    return jmodel, params, tmodel


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_full_forward_matches_jax(n_kv_heads):
    jmodel, params, tmodel = _models(n_kv_heads)
    toks = np.random.RandomState(0).randint(0, 320, (2, 24)).astype(np.int32)
    ref = jmodel.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(toks).long())
    assert out.dtype == torch.float32 and out.shape == (2, 24, 320)
    _close(out, ref)


@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_cached_steps_at_per_row_positions_match_jax(n_kv_heads):
    """A prefill of different lengths per row, then single-token cached
    steps at per-row positions, as the engine drives them."""
    jmodel, params, tmodel = _models(n_kv_heads)
    rng = np.random.RandomState(1)
    b, s0 = 2, 8
    prompt = rng.randint(0, 320, (b, s0)).astype(np.int32)
    pos0 = np.broadcast_to(np.arange(s0), (b, s0)).astype(np.int32)
    jl, jvars = jmodel.apply(params, jnp.asarray(prompt),
                             positions=jnp.asarray(pos0), decode=True,
                             mutable=["cache"])
    cache = tmodel.new_cache(b)
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(prompt).long(),
                    positions=torch.from_numpy(pos0).long(), cache=cache)
    _close(tl, jl)
    jcache = jvars["cache"]
    lens = np.asarray([s0, 5], np.int32)  # row 1 re-decodes from 5
    for step in range(6):
        tok = rng.randint(0, 320, (b, 1)).astype(np.int32)
        pos = lens[:, None]
        jl, jvars = jmodel.apply({**params, "cache": jcache},
                                 jnp.asarray(tok), positions=jnp.asarray(pos),
                                 decode=True, mutable=["cache"])
        jcache = jvars["cache"]
        with torch.no_grad():
            tl = tmodel(torch.from_numpy(tok).long(),
                        positions=torch.from_numpy(pos).long(), cache=cache)
        _close(tl, jl)
        lens = lens + 1
    # the in-place caches hold what the flax cache collection holds
    for i, (ck, cv) in enumerate(cache):
        layer = jcache[f"layer_{i}"]["attn"]
        _close(ck, layer["k"])
        _close(cv, layer["v"])


def test_rope_matches_jax():
    from ray_tpu.models.transformer import _rope as jax_rope

    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 3, 64).astype(np.float32)
    pos = rng.randint(0, 500, (2, 5)).astype(np.int32)
    _close(_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_params_from_flax_keys_and_outer_params_key():
    _, params, tmodel = _models(4)
    tree = jax.tree.map(np.asarray, params)
    with_key = params_from_flax(tree)
    without = params_from_flax(tree["params"])
    assert set(with_key) == set(tmodel.state_dict()) == set(without)
    for k in with_key:
        assert torch.equal(with_key[k], without[k])
    np.testing.assert_array_equal(
        with_key["layers.1.attn.wo"].numpy(),
        tree["params"]["layer_1"]["attn"]["wo"]["kernel"])


@pytest.mark.parametrize("n_kv_heads,moe_experts", [(4, 4), (2, 3), (4, 1)])
def test_moe_forward_matches_jax(n_kv_heads, moe_experts):
    """Top-2 (top-1 for one expert) dense-dispatch MoE blocks, with the
    reference's router, gates and experts carried by params_from_flax."""
    jmodel, params, tmodel = _models(n_kv_heads, moe_experts)
    assert all(hasattr(block, "moe") and not hasattr(block, "mlp")
               for block in tmodel.layers)
    toks = np.random.RandomState(3).randint(0, 320, (2, 24)).astype(np.int32)
    ref = jmodel.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(toks).long())
    _close(out, ref)


def test_params_from_flax_carries_the_moe_subtree():
    _, params, tmodel = _models(4, moe_experts=4)
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_flax(tree)
    assert set(sd) == set(tmodel.state_dict())
    moe = tree["params"]["layer_1"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(sd[f"layers.1.moe.{name}"].numpy(),
                                      moe[name])
    assert tuple(sd["layers.0.moe.w_down"].shape) == (4, 336, 128)


def test_seeded_moe_init_draws_flax_fan_in():
    """The seeded init draws the router at std 0.02 and each expert
    kernel [E, in, out] at std (E * in)^-0.5, flax's lecun_normal fan-in."""
    cfg = TransformerConfig(vocab_size=64, d_model=256, n_layers=1,
                            n_heads=4, d_ff=512, moe_experts=8)
    moe = Transformer(cfg, device="cpu", seed=1).layers[0].moe
    assert abs(float(moe.router.std()) - 0.02) < 2e-3
    for w in (moe.w_gate, moe.w_up, moe.w_down):
        want = (w.shape[0] * w.shape[1]) ** -0.5
        assert abs(float(w.std()) / want - 1) < 0.02


@pytest.mark.parametrize("n_layers,n_stages", [(8, 3), (4, 4), (5, 1)])
def test_stage_layer_split_matches_reference(n_layers, n_stages):
    from ray_tpu.llm.engine import stage_layer_split as jax_split

    assert stage_layer_split(n_layers, n_stages) == jax_split(n_layers,
                                                              n_stages)


def test_stage_param_slice_keeps_global_layer_names():
    sd = Transformer(TransformerConfig(vocab_size=16, d_model=64,
                                       n_layers=3, n_heads=1, n_kv_heads=1),
                     device="cpu").state_dict()
    first = stage_param_slice(sd, (0,), first=True, last=False)
    last = stage_param_slice(sd, (1, 2), first=False, last=True)
    assert "tok_emb" in first and "final_norm.scale" not in first
    assert {"tok_emb", "final_norm.scale"} <= set(last)
    assert all(not k.startswith("layers.0.") for k in last)
    assert set(first) | set(last) == set(sd)

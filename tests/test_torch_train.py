"""Training the port against the JAX package, on the CPU in float32.

The same weights (initialised by JAX, carried by `params_from_flax` /
`mlp_params_from_flax`) and the same numpy-seeded batches go through
`jax.value_and_grad` of the JAX package's `loss_fn` and through the port's
`loss_fn(...).backward()`; the optimizer step is `optax.adam(lr)` against
`torch.optim.Adam(lr=lr)` (the same update: b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias-corrected). Tolerances: losses within 1e-5
and gradients within 1e-4 (f32 on both sides, different summation
order); parameters after 3 Adam steps within 1e-5.

Adam's first steps move a weight by about lr * sign(g) whatever |g| is, so
an entry whose gradient is near zero, where the sign is set by rounding,
may move the other way in either framework. The step tests therefore hold
the port's loss and gradients to JAX's at every step and then step both
optimizers on JAX's gradients, so the parameters follow one trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models.mlp import MLP as JaxMLP
from ray_tpu.models.mlp import loss_fn as jax_mlp_loss
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import loss_fn as jax_loss
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.convert import (mlp_params_from_flax,
                                          params_from_flax)
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.models.mlp import loss_fn as mlp_loss
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              loss_fn)
from ray_tpu_torch.ops import flash_attention

SHAPE = dict(vocab_size=320, d_model=128, n_layers=2, n_heads=4, d_ff=336,
             max_seq=64)
GRAD_TOL = 1e-4


def _transformers(n_kv_heads=4, moe_experts=0):
    jcfg = JaxConfig(**SHAPE, n_kv_heads=n_kv_heads, dtype=jnp.float32,
                     moe_experts=moe_experts)
    jmodel = JaxTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = Transformer(TransformerConfig(
        **SHAPE, n_kv_heads=n_kv_heads, dtype=torch.float32,
        moe_experts=moe_experts), device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                         params)))
    return jmodel, params, tmodel


def _tokens(seed, length=33):
    return np.random.RandomState(seed).randint(
        0, SHAPE["vocab_size"], (2, length)).astype(np.int32)


def _step_on(tmodel, topt, ref_grads: dict):
    """torch.optim step on the reference's gradients (the port's own were
    checked against them first)."""
    for name, p in tmodel.named_parameters():
        p.grad = ref_grads[name].clone()
    topt.step()


def _assert_grads(tmodel, ref: dict, tol=GRAD_TOL):
    assert set(ref) == {n for n, _ in tmodel.named_parameters()}
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("n_kv_heads,moe_experts", [(4, 0), (2, 0), (4, 4),
                                                    (2, 3)])
def test_loss_and_grads_match_jax(n_kv_heads, moe_experts):
    """Dense and MoE, MHA and GQA: the next-token loss and the gradient of
    every parameter (router and experts included)."""
    jmodel, params, tmodel = _transformers(n_kv_heads, moe_experts)
    toks = _tokens(0)
    loss, grads = jax.value_and_grad(
        lambda p: jax_loss(jmodel, p, jnp.asarray(toks)))(params)
    tl = loss_fn(tmodel, torch.from_numpy(toks).long())
    tl.backward()
    assert abs(tl.item() - float(loss)) <= 1e-5
    _assert_grads(tmodel, params_from_flax(jax.tree.map(np.asarray, grads)))


def test_flash_function_in_the_model_matches_the_jax_grads(monkeypatch):
    """The model's attention through `flash_attention` (the autograd
    Function, the card's path, here on its plain versions): the incoming
    gradient comes through `flatten` and the `wo` product, and the loss and
    gradients still equal JAX's."""
    jmodel, params, tmodel = _transformers(2)
    monkeypatch.setattr(transformer, "dot_product_attention",
                        lambda q, k, v, causal=True: flash_attention(
                            q, k, v, causal=causal))
    toks = _tokens(1)
    loss, grads = jax.value_and_grad(
        lambda p: jax_loss(jmodel, p, jnp.asarray(toks)))(params)
    tl = loss_fn(tmodel, torch.from_numpy(toks).long())
    tl.backward()
    assert abs(tl.item() - float(loss)) <= 1e-5
    _assert_grads(tmodel, params_from_flax(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("moe_experts", [0, 4])
def test_adam_steps_match_optax(moe_experts):
    """Three steps of the reference's training step (value_and_grad, then
    optax.adam(1e-3)) against loss_fn, backward() and torch.optim.Adam:
    each step's loss within 1e-5 and gradients within 1e-4, every
    parameter within 1e-5 after."""
    jmodel, params, tmodel = _transformers(moe_experts=moe_experts)
    toks = _tokens(2)
    opt = optax.adam(1e-3)
    state = opt.init(params)
    topt = torch.optim.Adam(tmodel.parameters(), lr=1e-3)
    for _ in range(3):
        loss, grads = jax.value_and_grad(
            lambda p: jax_loss(jmodel, p, jnp.asarray(toks)))(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        tl = loss_fn(tmodel, torch.from_numpy(toks).long())
        tl.backward()
        assert abs(tl.item() - float(loss)) <= 1e-5
        ref_grads = params_from_flax(jax.tree.map(np.asarray, grads))
        _assert_grads(tmodel, ref_grads)
        _step_on(tmodel, topt, ref_grads)
    ref = params_from_flax(jax.tree.map(np.asarray, params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def _mlps(hidden=32):
    rng = np.random.RandomState(3)
    x = rng.rand(16, 28, 28).astype(np.float32)
    y = (rng.rand(16) * 10).astype(np.int32)
    jmodel = JaxMLP(hidden=hidden)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    tmodel = MLP(28 * 28, hidden=hidden, device="cpu")
    tmodel.load_state_dict(mlp_params_from_flax(jax.tree.map(np.asarray,
                                                             params)))
    return jmodel, params, tmodel, (x, y)


def test_mlp_forward_loss_and_grads_match_jax():
    jmodel, params, tmodel, (x, y) = _mlps()
    ref = jmodel.apply(params, jnp.asarray(x))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    with torch.no_grad():
        np.testing.assert_allclose(tmodel(batch[0]).numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=0)
    loss, grads = jax.value_and_grad(
        lambda p: jax_mlp_loss(jmodel, p, (jnp.asarray(x),
                                           jnp.asarray(y))))(params)
    tl = mlp_loss(tmodel, batch)
    tl.backward()
    assert abs(tl.item() - float(loss)) <= 1e-5
    _assert_grads(tmodel,
                  mlp_params_from_flax(jax.tree.map(np.asarray, grads)))


def test_mlp_adam_steps_match_optax():
    """The reference's MNIST step (tests/test_train.py: optax.adam(1e-2))
    for three steps: gradients within 1e-4 at each, parameters within 1e-5
    after."""
    jmodel, params, tmodel, (x, y) = _mlps()
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    opt = optax.adam(1e-2)
    state = opt.init(params)
    topt = torch.optim.Adam(tmodel.parameters(), lr=1e-2)
    for _ in range(3):
        grads = jax.grad(lambda p: jax_mlp_loss(jmodel, p, jbatch))(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        mlp_loss(tmodel, (torch.from_numpy(x), torch.from_numpy(y))).backward()
        ref_grads = mlp_params_from_flax(jax.tree.map(np.asarray, grads))
        _assert_grads(tmodel, ref_grads)
        _step_on(tmodel, topt, ref_grads)
    ref = mlp_params_from_flax(jax.tree.map(np.asarray, params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_mlp_keys_init_and_device():
    """The port's MLP has the flax tree's params, draws its kernels
    lecun-normal from the seed with zero biases, and asks for CUDA by
    default."""
    _, params, tmodel, _ = _mlps()
    assert set(mlp_params_from_flax(jax.tree.map(np.asarray, params))) == \
        set(tmodel.state_dict())
    fresh = MLP(512, hidden=256, device="cpu", seed=5)
    for layer in fresh.dense:
        assert torch.all(layer.bias == 0)
    assert abs(float(fresh.dense[0].kernel.std()) * 512 ** 0.5 - 1) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MLP(16)

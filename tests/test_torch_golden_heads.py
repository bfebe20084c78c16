"""The golden file at the JAX package's head widths: its own (D = 16 and
32) and the others its kernels take (D = 8, 80, 96 and 256).

`tests/data/torch_port_golden_heads.npz` carries, for the models of
`chip_smoke.HEADS_MODELS` in float32 (the dryrun's training model, d_model
128 in 8 heads, entry()'s, d_model 256 in 8 heads, and four 2-layer
models of heads of 8, 80, 96 and 256, each as LLMConfig derives it): each
model's full-forward logits on seeded tokens and its ContinuousEngine's
greedy tokens for two prompts, and for the training model and the four
others one step's `jax.value_and_grad(loss_fn)`: the loss and, per
parameter tensor, the gradient entries at seeded indices
(`chip_smoke.heads_grad_index`). The weights are not stored: both sides
draw them with numpy from a seed (`chip_smoke.heads_params`). The card
cannot run JAX, so the file is the reference there (chip_smoke.py's phases 15
and 16); these tests recompute it with the JAX package
and with the port on the CPU, so it cannot drift from either.

Regenerate with: JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_golden_heads.py
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from chip_smoke import (GOLDEN_HEADS, HEADS_MAX_TOKENS,  # noqa: E402
                        HEADS_MODELS, HEADS_PROMPTS, HEADS_TRAINED,
                        heads_flat, heads_grad_index, heads_params,
                        heads_tokens, heads_train_tokens)
from ray_tpu.llm import LLMConfig as JaxLLMConfig  # noqa: E402
from ray_tpu.llm.engine import ContinuousEngine as JaxEngine  # noqa: E402
from ray_tpu.llm.engine import SamplingParams as JaxSampling  # noqa: E402
from ray_tpu.llm.engine import model_config as jax_model_config  # noqa: E402
from ray_tpu.models.transformer import Transformer as JaxTransformer  # noqa: E402
from ray_tpu.models.transformer import loss_fn as jax_loss_fn  # noqa: E402
from ray_tpu_torch.llm import LLMConfig  # noqa: E402
from ray_tpu_torch.llm.engine import model_config  # noqa: E402
from ray_tpu_torch.models.convert import params_from_flax  # noqa: E402
from ray_tpu_torch.models.transformer import Transformer, loss_fn  # noqa: E402


def _jax_model(name: str, tree):
    lcfg = JaxLLMConfig(**HEADS_MODELS[name], dtype="float32",
                        params={"params": tree})
    return lcfg, JaxTransformer(jax_model_config(lcfg))


def jax_golden_heads() -> dict:
    """The file's arrays, computed by the JAX package on the CPU, plus each
    model's smallest top-1 margin over its greedy steps."""
    out = {}
    for name in HEADS_MODELS:
        tree = heads_params(name)
        lcfg, model = _jax_model(name, tree)
        out[f"{name}/logits"] = np.asarray(model.apply(
            {"params": tree}, jnp.asarray(heads_tokens(name))), np.float32)
        eng = JaxEngine(lcfg, max_batch=2, decode_chunk=4)
        try:
            greedy = [eng.submit(p, JaxSampling(
                temperature=0.0, max_tokens=HEADS_MAX_TOKENS)).tokens()
                for p in HEADS_PROMPTS]
        finally:
            eng.shutdown()
        out[f"{name}/greedy"] = np.asarray(greedy, np.int32)
        gaps = []
        for p, g in zip(HEADS_PROMPTS, greedy):
            seq = jnp.asarray([list(p) + g[:-1]], jnp.int32)
            lg = np.asarray(model.apply({"params": tree}, seq))[0]
            top2 = np.sort(lg[len(p) - 1:], axis=-1)[:, -2:]
            gaps.append(float(np.min(top2[:, 1] - top2[:, 0])))
        out[f"{name}/min_greedy_gap"] = np.float32(min(gaps))
        if name not in HEADS_TRAINED:
            continue
        loss, grads = jax.value_and_grad(lambda p: jax_loss_fn(
            model, p, jnp.asarray(heads_train_tokens(name))))(
                {"params": tree})
        out[f"{name}/loss"] = np.float32(loss)
        for key, g in heads_flat(grads["params"]).items():
            g = np.asarray(g, np.float32).reshape(-1)
            out[f"{name}/grad/{key}"] = g[heads_grad_index(key, g.size)]
    return out


def write_golden_heads(path: str = GOLDEN_HEADS) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **jax_golden_heads())


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_HEADS) as f:
        return {k: f[k] for k in f.files}


def test_golden_heads_file_is_small_and_names_both_widths(golden):
    assert os.path.getsize(GOLDEN_HEADS) < 1.5 * (1 << 20)
    widths = {name: cfg["d_model"] // cfg["n_heads"]
              for name, cfg in HEADS_MODELS.items()}
    assert widths == {"train": 16, "entry": 32, "d8": 8, "d80": 80,
                      "d96": 96, "d256": 256}
    for name in HEADS_MODELS:
        assert golden[f"{name}/logits"].shape == (
            2, 32, HEADS_MODELS[name]["vocab_size"])
        assert golden[f"{name}/greedy"].shape == (2, HEADS_MAX_TOKENS)
        # every greedy step has a clear top-1
        assert float(golden[f"{name}/min_greedy_gap"]) > 1e-3


def test_golden_heads_match_jax_package(golden):
    """The file is the JAX package's output: logits, loss and gradients to
    1e-5 (XLA's CPU code may differ between hosts in the last bits), greedy
    tokens exactly."""
    ref = jax_golden_heads()
    assert set(ref) == set(golden)
    for key, want in golden.items():
        if key.endswith("/greedy"):
            np.testing.assert_array_equal(ref[key], want)
        else:
            np.testing.assert_allclose(ref[key], want, atol=1e-5, rtol=0,
                                       err_msg=key)


def test_golden_heads_match_port_on_cpu(golden):
    """The port at the file's weights on the CPU, through chip_smoke's own
    function (the one the card runs) and its check: logits within 1e-4,
    greedy tokens equal, loss within 1e-5, kept gradient entries within
    1e-4 * max(1, |ref|)."""
    names = tuple(HEADS_MODELS)
    rec = chip_smoke.heads_check(golden,
                                 chip_smoke.heads_port_outputs("cpu", names),
                                 names)
    assert all(rec[f"{name}_logit_err"] <= 1e-4 for name in names)


@pytest.mark.parametrize("name", HEADS_TRAINED)
def test_port_training_step_matches_jax_in_every_gradient_entry(name):
    """One step of each trained model (D = 16, 8, 80, 96, 256): the port's
    loss and every entry of every parameter's gradient against
    jax.value_and_grad, f32, within 1e-5 and 1e-4 * max(1, |ref|)."""
    tree = heads_params(name)
    _, jmodel = _jax_model(name, tree)
    tokens = heads_train_tokens(name)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_loss_fn(
        jmodel, p, jnp.asarray(tokens)))({"params": tree})
    lcfg = LLMConfig(**HEADS_MODELS[name], dtype="float32")
    model = Transformer(model_config(lcfg), device="cpu")
    model.load_state_dict(params_from_flax(tree))
    loss = loss_fn(model, torch.from_numpy(tokens).long())
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-5
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        err = np.abs(p.grad.numpy() - r) / np.maximum(1.0, np.abs(r))
        assert err.max() <= 1e-4, name


if __name__ == "__main__":
    write_golden_heads(sys.argv[1] if len(sys.argv) > 1 else GOLDEN_HEADS)
    print("wrote", sys.argv[1] if len(sys.argv) > 1 else GOLDEN_HEADS)

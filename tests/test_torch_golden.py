"""The golden file that `chip_smoke.py` holds the port to on the card.

`tests/data/torch_port_golden.npz` carries, for a tiny float32 config
(vocab 384, d_model 128, 2 layers, 2 heads so D=64, max_seq 128):
weights drawn with numpy from a fixed seed (flax layout), the JAX
package's full-forward logits on seeded tokens, and the JAX package's
ContinuousEngine greedy tokens for two prompts. The card cannot run JAX, so
the file is the reference there; these tests recompute it with the JAX
package and with the port on the CPU, so it cannot drift from either.

Regenerate with: JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import ContinuousEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.llm.engine import model_config as jax_model_config
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu_torch.llm import LLMConfig
from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams
from ray_tpu_torch.llm.engine import model_config as port_model_config
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.transformer import Transformer

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.npz")
CONFIG = dict(vocab_size=384, d_model=128, n_layers=2, n_heads=2,
              max_seq=128)
#: order of the file's "config" entry
CONFIG_KEYS = ("vocab_size", "d_model", "n_layers", "n_heads", "max_seq")
SEED = 0
PROMPTS = ([5, 17, 250, 3, 99], [1, 2, 3, 4, 5, 6, 7, 8, 9])
MAX_TOKENS = 16


def golden_params(seed: int = SEED) -> dict:
    """Flax param tree (numpy f32) for CONFIG, drawn with numpy."""
    rng = np.random.RandomState(seed)
    d, h = CONFIG["d_model"], CONFIG["n_heads"]
    hd, ff = d // h, int(d * 8 / 3) // 8 * 8

    def normal(shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    def norm():
        return {"scale": (1.0 + 0.1 * rng.randn(d)).astype(np.float32)}

    tree = {"tok_emb": (0.02 * rng.randn(CONFIG["vocab_size"], d)
                        ).astype(np.float32)}
    for i in range(CONFIG["n_layers"]):
        tree[f"layer_{i}"] = {
            "attn_norm": norm(),
            "attn": {"wq": {"kernel": normal((d, h, hd), d)},
                     "wk": {"kernel": normal((d, h, hd), d)},
                     "wv": {"kernel": normal((d, h, hd), d)},
                     "wo": {"kernel": normal((h, hd, d), d)}},
            "mlp_norm": norm(),
            "mlp": {"w_gate": {"kernel": normal((d, ff), d)},
                    "w_up": {"kernel": normal((d, ff), d)},
                    "w_down": {"kernel": normal((ff, d), ff)}},
        }
    tree["final_norm"] = norm()
    return tree


def golden_tokens(seed: int = SEED) -> np.ndarray:
    return np.random.RandomState(seed + 1).randint(
        0, CONFIG["vocab_size"], size=(2, 32)).astype(np.int32)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _jax_golden(tree) -> dict:
    lcfg = JaxLLMConfig(**CONFIG, dtype="float32", params={"params": tree})
    model = JaxTransformer(jax_model_config(lcfg))
    tokens = golden_tokens()
    logits = np.asarray(model.apply({"params": tree}, jnp.asarray(tokens)))
    eng = JaxEngine(lcfg, max_batch=2, decode_chunk=4)
    try:
        greedy = [eng.submit(p, JaxSampling(temperature=0.0,
                                            max_tokens=MAX_TOKENS)).tokens()
                  for p in PROMPTS]
    finally:
        eng.shutdown()
    # Smallest gap between the greedy token's logit and the runner-up over
    # every generated position: how far the card's arithmetic may stray
    # before a greedy token could flip.
    gaps = []
    for p, g in zip(PROMPTS, greedy):
        seq = np.asarray([list(p) + g[:-1]], np.int32)
        lg = np.asarray(model.apply({"params": tree}, jnp.asarray(seq)))[0]
        top2 = np.sort(lg[len(p) - 1:], axis=-1)[:, -2:]
        gaps.append(float(np.min(top2[:, 1] - top2[:, 0])))
    out = {"tokens": tokens, "logits": logits.astype(np.float32),
           "greedy": np.asarray(greedy, np.int32),
           "min_greedy_gap": np.float32(min(gaps)),
           "config": np.asarray([CONFIG[k] for k in CONFIG_KEYS], np.int32)}
    out.update({f"prompt_{i}": np.asarray(p, np.int32)
                for i, p in enumerate(PROMPTS)})
    return out


def write_golden(path: str = GOLDEN) -> None:
    tree = golden_params()
    arrays = {f"params/{k}": v for k, v in _flatten(tree).items()}
    arrays.update(_jax_golden(tree))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_golden_weights_are_the_seeded_draw(golden):
    flat = _flatten(golden_params())
    assert set(flat) == {k[len("params/"):] for k in golden
                         if k.startswith("params/")}
    for k, v in flat.items():
        np.testing.assert_array_equal(golden[f"params/{k}"], v)


def test_golden_matches_jax_package(golden):
    """The file is the JAX package's output: logits to 1e-5 (XLA's CPU
    code generation may differ between hosts in the last bits), greedy
    tokens exactly, and every greedy step has a clear top-1."""
    ref = _jax_golden(golden_params())
    for key in ("tokens", "config", "prompt_0", "prompt_1"):
        np.testing.assert_array_equal(ref[key], golden[key])
    np.testing.assert_allclose(ref["logits"], golden["logits"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(ref["greedy"], golden["greedy"])
    assert float(golden["min_greedy_gap"]) > 1e-3


def test_golden_matches_port_on_cpu(golden):
    """The port at the file's weights: f32 full-forward logits within 1e-4
    (torch and XLA sum in different orders), greedy tokens equal."""
    tree = golden_params()
    model = Transformer(
        port_model_config(LLMConfig(**CONFIG, dtype="float32")), device="cpu")
    model.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        logits = model(torch.from_numpy(golden["tokens"]).long()).numpy()
    np.testing.assert_allclose(logits, golden["logits"], atol=1e-4, rtol=0)
    eng = ContinuousEngine(LLMConfig(**CONFIG, dtype="float32",
                                     params=params_from_flax(tree)),
                           max_batch=2, decode_chunk=4, device="cpu")
    try:
        greedy = [eng.submit(p, SamplingParams(temperature=0.0,
                                               max_tokens=MAX_TOKENS)).tokens()
                  for p in PROMPTS]
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.asarray(greedy), golden["greedy"])


if __name__ == "__main__":
    write_golden(sys.argv[1] if len(sys.argv) > 1 else GOLDEN)
    print("wrote", sys.argv[1] if len(sys.argv) > 1 else GOLDEN)

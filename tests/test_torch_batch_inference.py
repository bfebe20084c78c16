"""`ray_tpu_torch.llm.batch_inference`: `LLMPredictor` on a `data` actor
pool, on the CPU, held to the JAX package's greedy `LLMEngine` on the
golden file's weights; and the default device refusing to run without a
card.

Counterpart tests: the batch-inference case of tests/test_llm_serving.py.
The JAX engine runs in process (no runtime of the JAX package starts);
the port's cluster is this module's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu_torch import data as rd
from ray_tpu_torch.llm import LLMConfig, batch_inference
from test_torch_serve import _golden


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_batch_inference_equals_jax_greedy(cluster):
    shape, tree, _, _ = _golden()
    prompts = np.random.RandomState(5).randint(
        0, shape["vocab_size"], size=(6, 9)).astype(np.int32)
    want = np.asarray(JaxLLMEngine(JaxLLMConfig(
        **shape, params={"params": tree}, max_new_tokens=6)).generate(
            jnp.asarray(prompts)))
    ds = rd.from_items([{"tokens": p} for p in prompts], parallelism=3)
    cfg = LLMConfig(**shape, params={"params": tree}, max_new_tokens=6)
    rows = batch_inference(ds, cfg, concurrency=2, device="cpu").take_all()
    got = {tuple(r["tokens"]): r["generated"] for r in rows}
    assert len(got) == len(prompts)
    for p, w in zip(prompts, want):
        np.testing.assert_array_equal(got[tuple(p)], w)


def test_batch_inference_defaults_to_the_card(cluster):
    ds = rd.from_items([{"tokens": np.zeros(4, np.int32)}])
    with pytest.raises(Exception, match="CUDA is not available"):
        batch_inference(ds, LLMConfig()).take_all()

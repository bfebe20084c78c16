"""The port's serving surface over HTTP: `build_openai_app` and
`build_llm_deployment` on the port's own Serve (proxy, router, replica
actor), and `LLMEngine`, each held to the JAX package on the CPU.

Counterpart tests: tests/test_llm_serving.py (the OpenAI app over HTTP)
and tests/test_llm.py (LLMEngine). The golden file's greedy tokens are the
JAX package's ContinuousEngine output (tests/test_torch_golden.py keeps
them in step with it). The cluster is this module's own, on a free port.
"""

import json
import os
import socket
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp

import ray_tpu_torch as rt
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMConfig, LLMEngine, build_llm_deployment
from ray_tpu_torch.llm.openai import build_openai_app
from ray_tpu_torch.models.convert import params_from_flax

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.npz")
#: the reference HTTP test's model (tests/test_llm_serving.py)
CFG = LLMConfig(vocab_size=384, d_model=64, n_layers=2, n_heads=4,
                max_seq=128)


def _golden():
    with np.load(GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    tree: dict = {}
    for key, arr in g.items():
        if key.startswith("params/"):
            node = tree
            *parents, leaf = key[len("params/"):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    vocab, d_model, n_layers, n_heads, max_seq = (int(x) for x in g["config"])
    shape = dict(vocab_size=vocab, d_model=d_model, n_layers=n_layers,
                 n_heads=n_heads, max_seq=max_seq, dtype="float32")
    prompts = [g[f"prompt_{i}"].tolist() for i in range(g["greedy"].shape[0])]
    return shape, tree, prompts, g["greedy"]


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def base():
    """One cluster, one proxy, three applications: the reference test's
    OpenAI app at "/", the golden weights' OpenAI app at "/golden" and
    build_llm_deployment on the golden weights at "/gen"."""
    shape, tree, _, _ = _golden()
    rt.init(num_cpus=4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        serve.run(build_openai_app(CFG, model_id="test-llm", max_batch=4,
                                   decode_chunk=4, default_max_tokens=8,
                                   device="cpu"),
                  route_prefix="/", port=port)
        golden_cfg = LLMConfig(**shape, params=params_from_flax(tree))
        serve.run(build_openai_app(golden_cfg, name="golden", max_batch=2,
                                   decode_chunk=4, device="cpu"),
                  route_prefix="/golden", port=port)
        serve.run(build_llm_deployment(golden_cfg, name="gen", device="cpu"),
                  route_prefix="/gen", port=port)
        yield f"http://127.0.0.1:{port}"
    finally:
        serve.shutdown()
        rt.shutdown()


def test_http_models(base):
    with urllib.request.urlopen(f"{base}/v1/models", timeout=30) as r:
        models = json.loads(r.read())
    assert models["data"][0]["id"] == "test-llm"
    assert models["data"][0]["owned_by"] == "ray_tpu_torch"


def test_http_completion(base):
    out = _post(f"{base}/v1/completions",
                {"prompt": "hi", "max_tokens": 5, "temperature": 0.0})
    assert out["object"] == "text_completion"
    assert len(out["token_ids"]) == 5
    assert out["choices"][0]["finish_reason"] == "length"
    stats = json.loads(urllib.request.urlopen(f"{base}/v1/stats",
                                              timeout=30).read())
    assert stats["pid"] != os.getpid()  # the engine lives in the replica
    assert set(stats["kernel_launches"]) == {
        "decode_attention", "flash_attention", "flash_attention_bwd",
        "rms_norm", "rms_norm_bwd"}


def test_http_sse_stream_arrives_incrementally(base):
    req = urllib.request.Request(
        f"{base}/v1/completions",
        data=json.dumps({"prompt": "hi", "max_tokens": 6, "temperature": 0.0,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                chunks.append(None)
                break
            chunks.append(json.loads(payload))
    assert chunks[-1] is None  # [DONE] terminator
    deltas = [c for c in chunks[:-1] if c]
    toks = [t for c in deltas for t in c.get("token_ids", [])]
    assert len(toks) == 6
    # decode_chunk 4: the six tokens come in more than one event
    assert sum(1 for c in deltas if c["token_ids"]) >= 2
    assert deltas[-1]["choices"][0]["finish_reason"] == "length"
    full = _post(f"{base}/v1/completions",
                 {"prompt": "hi", "max_tokens": 6, "temperature": 0.0})
    assert toks == full["token_ids"]


def test_http_chat(base):
    out = _post(f"{base}/v1/chat/completions",
                {"messages": [{"role": "user", "content": "yo"}],
                 "max_tokens": 4, "temperature": 0.0})
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    assert len(out["token_ids"]) == 4


@pytest.mark.parametrize("stream", [False, True], ids=["completion", "sse"])
def test_http_golden_greedy_tokens_equal_jax(base, stream):
    _, _, prompts, greedy = _golden()
    for prompt, want in zip(prompts, greedy):
        body = {"prompt": prompt, "max_tokens": len(want),
                "temperature": 0.0}
        if not stream:
            got = _post(f"{base}/golden/v1/completions", body)["token_ids"]
        else:
            req = urllib.request.Request(
                f"{base}/golden/v1/completions",
                data=json.dumps({**body, "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            got = []
            with urllib.request.urlopen(req, timeout=120) as r:
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("data: {"):
                        got += json.loads(line[6:])["token_ids"]
        assert got == want.tolist()


@pytest.fixture(scope="module")
def golden_engines():
    shape, tree, _, _ = _golden()
    jax_eng = JaxLLMEngine(JaxLLMConfig(**shape, params={"params": tree}))
    port_eng = LLMEngine(LLMConfig(**shape, params={"params": tree}),
                         device="cpu")
    return jax_eng, port_eng


def _prompts(vocab):
    return np.random.RandomState(3).randint(0, vocab, size=(2, 7)).astype(
        np.int32)


@pytest.mark.parametrize("n_new", [1, 9])
def test_llm_engine_generate_equals_jax(golden_engines, n_new):
    jax_eng, port_eng = golden_engines
    prompts = _prompts(jax_eng.cfg.vocab_size)
    want = jax_eng.generate(jnp.asarray(prompts), max_new_tokens=n_new)
    got = port_eng.generate(prompts, max_new_tokens=n_new)
    assert got.dtype == np.int32 and got.shape == (2, 7 + n_new)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_llm_engine_rejects_past_max_seq(golden_engines):
    prompts = _prompts(golden_engines[0].cfg.vocab_size)
    n = golden_engines[0].cfg.max_seq - 7 + 1
    for eng in golden_engines:
        with pytest.raises(ValueError, match="max_seq"):
            eng.generate(prompts, max_new_tokens=n)


def test_llm_deployment_over_http_equals_jax(base, golden_engines):
    jax_eng, _ = golden_engines
    prompts = _prompts(jax_eng.cfg.vocab_size)
    want = np.asarray(jax_eng.generate(jnp.asarray(prompts),
                                       max_new_tokens=5))
    out = _post(f"{base}/gen", {"tokens": prompts.tolist(),
                                "max_new_tokens": 5})
    assert out["generated"] == want.tolist()
    one = _post(f"{base}/gen", {"tokens": prompts[0].tolist(),
                                "max_new_tokens": 5})
    assert one["generated"] == want[:1].tolist()


def test_pipelined_engine_is_refused_by_name(base):
    """pipeline_stages=2 on the card where there is none: each stage actor
    refuses in its constructor, and the server's build raises the first
    stage's failure as a DagStageError naming it."""
    import torch

    from ray_tpu_torch.exceptions import DagStageError
    from ray_tpu_torch.llm.openai import OpenAIServer

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the stages would start")
    with pytest.raises(DagStageError, match="CUDA is not available") as ei:
        OpenAIServer(CFG, pipeline_stages=2, device="cuda")
    assert ei.value.stage == "step[0]"

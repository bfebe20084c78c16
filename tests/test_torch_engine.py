"""The port's continuous-batching engine and OpenAI surface on the CPU.

The six engine tests of tests/test_llm_serving.py rerun on the port with
device="cpu"; greedy tokens equal the JAX package's ContinuousEngine at
converted weights (float32); the top-k/top-p kept set equals the one the
reference's sampler formula gives with jax.numpy on the same logits.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import ContinuousEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.llm.engine import model_config as jax_model_config
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu_torch.llm import LLMConfig
from ray_tpu_torch.llm.engine import (ContinuousEngine, GenStream,
                                      SamplingParams, _gumbel, _mask_logits,
                                      _sample, stream_key)
from ray_tpu_torch.llm.openai import OpenAIServer

SHAPE = dict(vocab_size=384, d_model=64, n_layers=2, n_heads=4, max_seq=128)
CFG = LLMConfig(**SHAPE)


@pytest.fixture(scope="module")
def engine():
    eng = ContinuousEngine(CFG, max_batch=4, decode_chunk=4, device="cpu")
    yield eng
    eng.shutdown()


# ---- the engine tests of tests/test_llm_serving.py, on the port
def test_engine_greedy_deterministic(engine):
    a = engine.submit([1, 2, 3], SamplingParams(temperature=0.0,
                                                max_tokens=6)).tokens()
    b = engine.submit([1, 2, 3], SamplingParams(temperature=0.0,
                                                max_tokens=6)).tokens()
    assert a == b and len(a) == 6


def test_engine_no_lockstep(engine):
    """Requests of different lengths complete independently."""
    long_s = engine.submit([5, 6, 7], SamplingParams(temperature=0.0,
                                                     max_tokens=120))
    first_long = long_s.next(timeout=60)
    t0 = time.monotonic()
    short = engine.submit([8, 9], SamplingParams(temperature=0.0,
                                                 max_tokens=3)).tokens()
    short_done = time.monotonic() - t0
    assert engine.num_active >= 1
    assert len(short) == 3
    long_toks = [first_long] + long_s.tokens()
    assert len(long_toks) == 120
    assert short_done < 30.0


def test_engine_join_running_batch(engine):
    """A request submitted mid-decode joins the running batch."""
    long_s = engine.submit([1], SamplingParams(temperature=0.0,
                                               max_tokens=80))
    first_long = long_s.next(timeout=60)
    joiner = engine.submit([2, 3], SamplingParams(temperature=0.0,
                                                  max_tokens=4))
    first_join = joiner.next(timeout=60)
    assert isinstance(first_long, int) and isinstance(first_join, int)
    assert engine.num_active >= 1
    joiner.tokens()
    long_s.tokens()


def test_engine_sampling_modes(engine):
    greedy = engine.submit([1, 2, 3], SamplingParams(
        temperature=0.0, max_tokens=8)).tokens()
    topk1 = engine.submit([1, 2, 3], SamplingParams(
        temperature=1.0, top_k=1, max_tokens=8)).tokens()
    assert topk1 == greedy  # top_k=1 collapses to greedy
    hot1 = engine.submit([1, 2, 3], SamplingParams(
        temperature=8.0, max_tokens=16, seed=11)).tokens()
    hot2 = engine.submit([1, 2, 3], SamplingParams(
        temperature=8.0, max_tokens=16, seed=22)).tokens()
    assert hot1 != hot2  # high temperature + different seeds diverge
    capped = engine.submit([1, 2, 3], SamplingParams(
        temperature=8.0, top_p=1e-9, max_tokens=8, seed=5)).tokens()
    assert capped == greedy  # tiny top_p keeps only the argmax token


def test_engine_stop_token(engine):
    base = engine.submit([4, 5], SamplingParams(
        temperature=0.0, max_tokens=12)).tokens()
    stop = base[3]
    s = engine.submit([4, 5], SamplingParams(
        temperature=0.0, max_tokens=12, stop_token=int(stop)))
    toks = s.tokens()
    assert toks[-1] == stop and len(toks) == 4
    assert s.finish_reason == "stop"


def test_engine_overflow_rejected(engine):
    with pytest.raises(ValueError, match="max_seq"):
        engine.submit(list(range(100)), SamplingParams(max_tokens=100))


@pytest.mark.parametrize("prompt", [[1, -1], [SHAPE["vocab_size"]]])
def test_engine_rejects_token_ids_outside_the_vocab(engine, prompt):
    with pytest.raises(ValueError, match="token ids"):
        engine.submit(prompt, SamplingParams(max_tokens=2))


# ---- parity with the JAX package
@pytest.mark.parametrize("prefill_lane", ["1", "0"])
def test_greedy_tokens_equal_jax_engine(prefill_lane, monkeypatch):
    """Same converted weights, same prompts (joining a running batch at
    different depths): the port's greedy tokens equal the reference's."""
    monkeypatch.setenv("RT_LLM_PREFILL_LANE", prefill_lane)
    jcfg = JaxLLMConfig(**SHAPE)
    params = JaxTransformer(jax_model_config(jcfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(np.asarray, params)
    prompts = [[1, 2, 3], [7] * 11, list(range(40, 60)), [300, 5]]
    sp = dict(temperature=0.0, max_tokens=20)
    jeng = JaxEngine(JaxLLMConfig(**SHAPE, params=params), max_batch=3,
                     decode_chunk=4)
    try:
        ref = [s.tokens() for s in
               [jeng.submit(p, JaxSampling(**sp)) for p in prompts]]
    finally:
        jeng.shutdown()
    peng = ContinuousEngine(LLMConfig(**SHAPE, params=tree), max_batch=3,
                            decode_chunk=4, device="cpu")
    try:
        assert peng._prefill_lane is (prefill_lane == "1")
        out = [s.tokens() for s in
               [peng.submit(p, SamplingParams(**sp)) for p in prompts]]
    finally:
        peng.shutdown()
    assert out == ref


def _jax_kept(logits, temp, top_k, top_p, vocab):
    """engine.py's _make_sampler masking (its lines before the draw),
    evaluated with jax.numpy; returns the kept-token mask."""
    lt = logits / jnp.maximum(temp, 1e-6)[:, None]
    sorted_lt = jnp.sort(lt, axis=-1)[:, ::-1]
    k_eff = jnp.clip(jnp.where(top_k > 0, top_k, vocab), 1, vocab)
    kth = jnp.take_along_axis(sorted_lt, (k_eff - 1)[:, None], axis=-1)
    lt = jnp.where(lt < kth, -jnp.inf, lt)
    probs = jax.nn.softmax(lt, axis=-1)
    sp = jnp.sort(probs, axis=-1)[:, ::-1]
    csum = jnp.cumsum(sp, axis=-1)
    keep = (csum - sp) < top_p[:, None]
    min_keep = jnp.min(jnp.where(keep, sp, jnp.inf), axis=-1, keepdims=True)
    lt = jnp.where(probs < min_keep, -jnp.inf, lt)
    return np.isfinite(np.asarray(lt))


def test_topk_topp_kept_set_equals_reference():
    rng = np.random.RandomState(0)
    vocab = 97
    logits = (3 * rng.randn(6, vocab)).astype(np.float32)
    temp = np.asarray([1.0, 0.5, 2.0, 1.0, 0.7, 1.0], np.float32)
    top_k = np.asarray([0, 5, 0, 1, 20, 40], np.int32)
    top_p = np.asarray([1.0, 1.0, 0.9, 1.0, 0.5, 1e-9], np.float32)
    port = _mask_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(top_k).long(),
                        torch.from_numpy(top_p), vocab)
    ref = _jax_kept(*map(jnp.asarray, (logits, temp, top_k, top_p)), vocab)
    np.testing.assert_array_equal(torch.isfinite(port).numpy(), ref)
    assert ref[0].all() and ref[3].sum() == 1 and ref[5].sum() == 1


def test_sampling_noise_depends_only_on_its_own_slot():
    """A slot's draw is a function of (seed, request id, token index): the
    same key and step give the same noise whatever the batch around it."""
    keys = torch.tensor([stream_key(7, 3), stream_key(1, 2),
                         stream_key(7, 4)])
    steps = torch.tensor([5, 0, 5])
    g = _gumbel(keys, steps, 50)
    alone = _gumbel(keys[:1], steps[:1], 50)
    assert torch.equal(g[0], alone[0])
    assert not torch.equal(g[0], g[2])  # another request id differs
    assert torch.isfinite(g).all()
    logits = torch.zeros(3, 50)
    ones = torch.ones(3)
    toks = _sample(logits, keys, steps, ones, torch.zeros(3, dtype=torch.long),
                   ones, 50)
    assert toks[0] == _sample(logits[:1], keys[:1], steps[:1], ones[:1],
                              torch.zeros(1, dtype=torch.long), ones[:1],
                              50)[0]


def test_sampling_draws_follow_the_distribution():
    """Gumbel-max over the hash noise samples softmax(logits): over 4000
    independent (key, step) pairs the token frequencies match."""
    p = torch.tensor([0.5, 0.3, 0.15, 0.05])
    n = 4000
    keys = torch.full((n,), stream_key(3, 9), dtype=torch.long)
    steps = torch.arange(n)
    toks = torch.argmax(p.log()[None] + _gumbel(keys, steps, 4), dim=-1)
    freq = torch.bincount(toks, minlength=4).float() / n
    # 4 standard errors of a binomial proportion at n=4000 is <= 0.032
    assert torch.allclose(freq, p, atol=0.032)


def test_scheduler_death_reaches_every_open_stream():
    """A scheduler that dies reports an attributed error on each stream."""
    eng = ContinuousEngine(CFG, max_batch=2, decode_chunk=2, device="cpu")

    def boom(*a, **k):
        raise MemoryError("injected")

    eng._run_scheduler = boom  # takes effect on a fresh loop below
    eng.shutdown()
    eng._running = True
    streams = [GenStream(i, 1) for i in range(3)]
    for s in streams:
        eng._streams.add(s)
    eng._loop()
    for s in streams:
        with pytest.raises(RuntimeError, match="scheduler died"):
            s.tokens()


# ---- the OpenAI surface
class _Req:
    def __init__(self, path, body=None):
        self.path = path
        self._body = body

    def json(self):
        return self._body


@pytest.fixture(scope="module")
def server():
    srv = OpenAIServer(CFG, model_id="port-llm", max_batch=4, decode_chunk=4,
                       default_max_tokens=6, device="cpu")
    yield srv
    srv.shutdown()


def test_openai_models_and_completion(server):
    models = server(_Req("/v1/models"))
    assert models["data"][0]["id"] == "port-llm"
    out = server(_Req("/v1/completions",
                      {"prompt": "hi", "temperature": 0.0, "max_tokens": 5}))
    choice = out["choices"][0]
    assert out["object"] == "text_completion"
    assert len(out["token_ids"]) == 5 and choice["finish_reason"] == "length"
    again = server(_Req("/v1/completions",
                        {"prompt": "hi", "temperature": 0.0, "max_tokens": 5}))
    assert again["token_ids"] == out["token_ids"]


def test_openai_stream_and_chat(server):
    chunks = list(server(_Req("/v1/completions",
                              {"prompt": [1, 2, 3], "temperature": 0.0,
                               "max_tokens": 7, "stream": True})))
    toks = [t for c in chunks for t in c["token_ids"]]
    assert len(toks) == 7 and chunks[-1]["choices"][0]["finish_reason"] == \
        "length"
    full = server(_Req("/v1/completions", {"prompt": [1, 2, 3],
                                           "temperature": 0.0,
                                           "max_tokens": 7}))
    assert toks == full["token_ids"]
    chat = server(_Req("/v1/chat/completions",
                       {"messages": [{"role": "user", "content": "yo"}],
                        "temperature": 0.0}))
    assert chat["object"] == "chat.completion"
    assert chat["choices"][0]["message"]["role"] == "assistant"
    assert len(chat["token_ids"]) == 6  # default_max_tokens


# ---- tracing: the reference's engine spans and decode-step histogram
TRACE_CTX = ("a" * 32, "b" * 16)


def _traced(monkeypatch, tracing, metrics):
    """Turn one package's tracing on in this process, capture the spans it
    records and count its decode-step observations."""
    spans, observed = [], []

    def record(trace_id, span_id, parent, name, kind, start, end,
               attrs=None):
        spans.append({"t": trace_id, "p": parent, "n": name, "k": kind,
                      "a": start, "b": end, "at": attrs or {}})

    monkeypatch.setattr(tracing, "_ON", True)
    monkeypatch.setattr(tracing, "record_span", record)
    monkeypatch.setattr(metrics.DECODE_STEP_SECONDS, "observe",
                        lambda value, tags=None: observed.append(value))
    return spans, observed


def _traced_request(eng, tracing, sampling):
    token = tracing._ctx.set(TRACE_CTX)
    try:
        stream = eng.submit(list(range(1, 13)), sampling)
    finally:
        tracing._ctx.reset(token)
    return stream.tokens()


def test_engine_spans_and_decode_histogram_match_jax_engine(monkeypatch):
    """One traced greedy request of 24 tokens at decode_chunk 4, prefill
    lane off, through both engines: the same set of engine.* span names,
    all under the submitting request's context, and each engine observes
    DECODE_STEP_SECONDS once per traced host_sync span, whose count stays
    within the reference test's ceil(24/4) + 7."""
    from ray_tpu._private import tracing as jax_tracing
    from ray_tpu.util import metrics as jax_metrics
    from ray_tpu_torch._private import tracing as port_tracing
    from ray_tpu_torch.util import metrics as port_metrics

    monkeypatch.setenv("RT_LLM_PREFILL_LANE", "0")
    jax_spans, jax_obs = _traced(monkeypatch, jax_tracing, jax_metrics)
    port_spans, port_obs = _traced(monkeypatch, port_tracing, port_metrics)
    jeng = JaxEngine(JaxLLMConfig(**SHAPE), max_batch=4, decode_chunk=4)
    try:
        jtoks = _traced_request(jeng, jax_tracing, JaxSampling(
            temperature=0.0, max_tokens=24))
    finally:
        jeng.shutdown()
    peng = ContinuousEngine(CFG, max_batch=4, decode_chunk=4, device="cpu")
    try:
        assert peng._prefill_lane is False
        ptoks = _traced_request(peng, port_tracing, SamplingParams(
            temperature=0.0, max_tokens=24))
    finally:
        peng.shutdown()
    assert len(jtoks) == len(ptoks) == 24
    names = {s["n"] for s in port_spans}
    assert names == {s["n"] for s in jax_spans} == {
        "engine.prefill", "engine.dispatch_chunk", "engine.host_sync"}
    bound = -(-24 // 4) + 7
    for spans, observed in ((jax_spans, jax_obs), (port_spans, port_obs)):
        assert all((s["t"], s["p"]) == TRACE_CTX and s["k"] == "engine"
                   and s["b"] >= s["a"] for s in spans)
        syncs = [s for s in spans if s["n"] == "engine.host_sync"]
        assert 2 <= len(syncs) <= bound
        assert len(observed) == len(syncs)
    prefill = [s for s in port_spans if s["n"] == "engine.prefill"]
    assert [s["at"] for s in prefill] == [{"prompt_len": 12}]
    chunks = [s["at"] for s in port_spans if s["n"] == "engine.dispatch_chunk"]
    assert sum(c["tokens"] for c in chunks) == 23  # the first is prefill's
    assert all(c["active"] == 1 for c in chunks)
    syncs = [s["at"] for s in port_spans if s["n"] == "engine.host_sync"]
    assert sum(s["cols"] for s in syncs) == 24


def test_engine_records_no_span_with_tracing_off(engine, monkeypatch):
    from ray_tpu_torch._private import tracing as port_tracing
    from ray_tpu_torch.util import metrics as port_metrics

    spans, observed = _traced(monkeypatch, port_tracing, port_metrics)
    monkeypatch.setattr(port_tracing, "_ON", False)
    assert len(_traced_request(engine, port_tracing, SamplingParams(
        temperature=0.0, max_tokens=8))) == 8
    assert spans == [] and observed == []


def _covered(root, spans) -> float:
    """Seconds of the root span's window covered by the union of the other
    spans, each clipped to it."""
    ivs = sorted((max(s["a"], root["a"]), min(s["b"], root["b"]))
                 for s in spans if s is not root and s["b"] > s["a"])
    covered, cur = 0.0, None
    for a, b in ivs:
        if b <= a:
            continue
        if cur is None:
            cur = [a, b]
        elif a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            covered += cur[1] - cur[0]
            cur = [a, b]
    if cur is not None:
        covered += cur[1] - cur[0]
    return covered


def test_serve_streaming_trace_accounts_request_wall_time(monkeypatch):
    """Copy of tests/test_tracing.py's serve criterion on the port: a
    traced streaming request over HTTP to a CPU replica; the spans cover
    at least 90% of the request's wall, with the engine's prefill, chunk
    dispatch and per-chunk host-sync spans in its trace and the host
    syncs within ceil(24/4) + 7."""
    import json
    import socket
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.openai import build_openai_app
    from ray_tpu_torch.util import state

    monkeypatch.setenv("RT_TRACING", "1")
    rt.init(num_cpus=4)
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        serve.run(build_openai_app(CFG, model_id="traced-llm", max_batch=4,
                                   decode_chunk=4, default_max_tokens=24,
                                   device="cpu"),
                  route_prefix="/", port=port)
        body = json.dumps({"prompt": "hello tracer", "max_tokens": 24,
                           "temperature": 0.0, "stream": True}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        ntok = 0
        with urllib.request.urlopen(req, timeout=180) as r:
            for line in r:
                line = line.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    ntok += len(json.loads(line[6:]).get("token_ids", []))
        assert ntok >= 24

        def request_trace():
            for row in state.list_traces(limit=1000):
                if not row["complete"] or not str(
                        row.get("name") or "").startswith("http POST"):
                    continue
                spans = state.get_trace(row["trace_id"])["spans"]
                if (any(s["n"] == "engine.host_sync" for s in spans)
                        and any(s["k"] == "execute" for s in spans)
                        and any(s["p"] is None for s in spans)):
                    return spans
            return None

        deadline = time.monotonic() + 40
        spans = request_trace()
        while spans is None and time.monotonic() < deadline:
            time.sleep(0.2)
            spans = request_trace()
        assert spans is not None, "no request trace with engine spans"
        root = next(s for s in spans if s["p"] is None)
        wall = root["b"] - root["a"]
        assert wall > 0
        covered = _covered(root, spans)
        assert covered >= 0.9 * wall, (
            f"spans cover only {covered / wall:.1%} of the request's "
            f"{wall * 1e3:.0f}ms wall time")
        syncs = [s for s in spans if s["n"] == "engine.host_sync"]
        assert 2 <= len(syncs) <= -(-24 // 4) + 4 + 3, syncs
        assert any(s["n"] == "engine.dispatch_chunk" for s in spans)
        assert any(s["n"] == "engine.prefill" for s in spans)
    finally:
        serve.shutdown()
        rt.shutdown()

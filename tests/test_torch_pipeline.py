"""The port's pipeline-parallel engine on the CPU: stage nets, the
2-stage `PipelinedEngine` held to the JAX package's ContinuousEngine and
the golden file, sampled decode against the port's ContinuousEngine, the
zero-RPC steady state, the pre-negotiated stage group, serving over HTTP
with `pipeline_stages=2`, and the stage-death contract.

Counterpart tests: tests/test_llm_pipeline.py (the same tiny model:
vocab 128, d_model 64, 2 layers, 4 heads, max_seq 64) and, for stage
death and shutdown, tests/test_chaos_llm_pipeline.py, whose SIGKILL case
is held here to the port's own test: stage 1 killed through the
runtime's `kill`. Weights go from JAX to the port through
`models/convert.params_from_flax`. The cluster is this module's own.
"""

import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch as rt
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import ContinuousEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.llm.engine import model_config as jax_model_config
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu_torch.exceptions import DagStageError, GetTimeoutError
from ray_tpu_torch.llm import LLMConfig
from ray_tpu_torch.llm.engine import (ContinuousEngine, SamplingParams,
                                      make_stage_net, model_config,
                                      stage_layer_split, stage_param_slice)
from ray_tpu_torch.llm.pipeline import PipelinedEngine
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.transformer import Transformer

# d_model=64 x microbatch=4 puts the f32 decode activation (4*1*64*4 B =
# 1 KiB) exactly at the device-edge threshold, so the zero-RPC test pins.
CFG_KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq=64)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.npz")


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _jax_tree(shape: dict, seed: int = 0):
    params = JaxTransformer(jax_model_config(JaxLLMConfig(**shape))).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return params, jax.tree.map(np.asarray, params)


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


# ---------------------------------------------------------- stage nets
def _full_and_stages(n_stages: int):
    mcfg = model_config(LLMConfig(**CFG_KW))
    full = Transformer(mcfg, device="cpu", seed=3).eval()
    sd = full.state_dict()
    nets = []
    for s, layers in enumerate(stage_layer_split(CFG_KW["n_layers"],
                                                 n_stages)):
        net = make_stage_net(mcfg, layers, s == 0, s == n_stages - 1,
                             device="cpu")
        shard = stage_param_slice(sd, layers, s == 0, s == n_stages - 1)
        net.load_state_dict(shard, strict=True)
        nets.append(net.eval())
    return full, nets


def _run_stages(nets, toks, positions, caches=None):
    x = toks
    for i, net in enumerate(nets):
        x = net(x, positions, cache=None if caches is None else caches[i])
    return x


@pytest.mark.parametrize("n_stages", [1, 2])
@torch.no_grad()
def test_stage_nets_compose_to_the_transformer(n_stages):
    """One stage computes exactly what the full Transformer computes; two
    stages composed agree within 1e-6 (f32), both over a full sequence and
    through the slot caches (a prefill, then a single-token step)."""
    full, nets = _full_and_stages(n_stages)
    assert "tok_emb" in nets[0].state_dict()
    assert "final_norm.scale" in nets[-1].state_dict()
    keys = sorted(k for n in nets for k in n.state_dict()
                  if k.startswith("layers."))
    assert keys == sorted(k for k in full.state_dict()
                          if k.startswith("layers."))
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, CFG_KW["vocab_size"], (2, 9)))
    pos = torch.arange(9).expand(2, 9)
    want = full(toks, pos)
    got = _run_stages(nets, toks, pos)
    fc = full.new_cache(2)
    sc = [n.new_cache(2) for n in nets]
    want_p = full(toks, pos, cache=fc)
    got_p = _run_stages(nets, toks, pos, caches=sc)
    nxt = torch.argmax(want_p[:, -1], -1)[:, None]
    step_pos = torch.full((2, 1), 9)
    want_d = full(nxt, step_pos, cache=fc)
    got_d = _run_stages(nets, nxt, step_pos, caches=sc)
    for w, g in ((want, got), (want_p, got_p), (want_d, got_d)):
        if n_stages == 1:
            assert torch.equal(w, g)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ------------------------------------------------------- engine parity
def test_greedy_parity_with_jax_and_port_engines(cluster):
    """Greedy decode through the 2-stage pipeline gives exactly the tokens
    of the JAX package's ContinuousEngine and of the port's, on the same
    converted weights — and again, so stage caches reset between rounds."""
    params, tree = _jax_tree(CFG_KW)
    prompts = [[1, 2, 3], [9, 8], [17], [4, 5, 6, 7]]
    sp = dict(temperature=0.0, max_tokens=12)
    jeng = JaxEngine(JaxLLMConfig(**CFG_KW, params=params), max_batch=4,
                     decode_chunk=4)
    try:
        ref = jeng.generate(prompts, JaxSampling(**sp))
    finally:
        jeng.shutdown()
    peng = ContinuousEngine(LLMConfig(**CFG_KW, params=tree), max_batch=4,
                            decode_chunk=4, device="cpu")
    try:
        port = peng.generate(prompts, SamplingParams(**sp))
    finally:
        peng.shutdown()
    pipe = PipelinedEngine(LLMConfig(**CFG_KW, params=tree), n_stages=2,
                           max_batch=4, microbatch=2, device="cpu")
    try:
        got = pipe.generate(prompts, SamplingParams(**sp))
        assert got == ref
        assert got == port
        assert pipe.generate(prompts, SamplingParams(**sp)) == ref
    finally:
        pipe.shutdown()


def test_golden_greedy_tokens(cluster):
    shape, tree, prompts, greedy = _golden()
    pipe = PipelinedEngine(LLMConfig(**shape, params=params_from_flax(tree)),
                           n_stages=2, max_batch=2, device="cpu")
    try:
        got = pipe.generate(prompts, SamplingParams(
            temperature=0.0, max_tokens=greedy.shape[1]))
    finally:
        pipe.shutdown()
    np.testing.assert_array_equal(np.asarray(got), greedy)


def test_sampled_decode_equals_port_engine(cluster):
    """For the same request ids, sampled tokens equal the port's
    ContinuousEngine's: the last stage draws with the same sampler on
    (stream_key(seed, request_id), token index). num_active returns to 0
    and an over-long request is refused."""
    prompts = [[1, 2], [3, 4], [5, 6]]
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, max_tokens=10,
                        seed=7)
    peng = ContinuousEngine(LLMConfig(**CFG_KW), max_batch=4,
                            decode_chunk=4, device="cpu")
    try:
        want = peng.generate(prompts, sp)
    finally:
        peng.shutdown()
    pipe = PipelinedEngine(LLMConfig(**CFG_KW), n_stages=2, max_batch=4,
                           microbatch=2, device="cpu")
    try:
        got = pipe.generate(prompts, sp)
        assert got == want
        assert all(len(t) == 10 and all(0 <= x < CFG_KW["vocab_size"]
                                        for x in t) for t in got)
        assert pipe.num_active == 0
        with pytest.raises(ValueError, match="max_seq"):
            pipe.submit(list(range(60)), SamplingParams(max_tokens=60))
    finally:
        pipe.shutdown()


def test_zero_rpc_steady_state(cluster):
    """Over a post-warm-up decode window activation placeholders flow on
    the inter-stage edge (edge_pins > 0), every consumer resolve lands in
    the local store, and no resolve takes an export or fetch RPC; each
    stage counted its decode invocations."""
    pipe = PipelinedEngine(LLMConfig(**CFG_KW), n_stages=2, max_batch=8,
                           microbatch=4, device="cpu")
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=16)
        pipe.generate([[1, 2, 3]] * 8, sp)  # warm: channel loops, conns
        pipe.reset_pipeline_stats()
        pipe.generate([[i + 1, i + 2] for i in range(8)], sp)
        stats = pipe.pipeline_stats()
        assert stats["edge_pins"] > 0, stats
        assert stats["store_hits"] > 0, stats
        assert stats["resolve_rpcs"] == 0, stats
        assert len(stats["stages"]) == 2
        for s in stats["stages"]:
            assert s["steps"] > 0 and s["busy_s"] > 0
            assert s["decode_steps"] > 0 and s["pid"] != os.getpid()
            assert s["device"] == "cpu" and s["device_bytes"] == 0
        assert stats["stages"][0]["pid"] != stats["stages"][1]["pid"]
    finally:
        pipe.shutdown()


def test_occupancy_snapshot_windowed_per_consumer():
    """Each consumer's window is its own: the first call anchors (0.0),
    later calls report the busy fraction since that consumer's last."""
    from ray_tpu_torch.llm import pipeline as pp

    stage = "pp-test-occ"
    pp._occ_record(stage, 0.0)
    assert pp.occupancy_snapshot("occ-a")[stage] == 0.0  # anchor
    pp.occupancy_snapshot("occ-b")
    pp._occ_record(stage, 0.04)
    time.sleep(0.08)
    frac_a = pp.occupancy_snapshot("occ-a")[stage]
    assert 0.0 < frac_a <= 1.0
    frac_b = pp.occupancy_snapshot("occ-b")[stage]
    assert 0.0 < frac_b <= 1.0
    assert pp.occupancy_snapshot("occ-a")[stage] < frac_a


# --------------------------------------------- pre-negotiated stage group
def test_prenegotiated_group_skips_kv_rendezvous(cluster):
    """Joining with a pushed address map publishes nothing to the
    controller KV and the group still allreduces."""
    from ray_tpu_torch._private.worker import global_worker

    @rt.remote
    class PreWorker:
        def addr(self):
            from ray_tpu_torch._private.worker import global_worker as gw

            return tuple(gw().server_addr)

        def join(self, world, rank, addrs, group):
            from ray_tpu_torch.util import collective as col

            col.init_prenegotiated_group(world, rank, addrs, group,
                                         connect=True)
            return True

        def allreduce(self, value, group):
            from ray_tpu_torch.util import collective as col

            return col.allreduce(np.asarray(value, np.float32),
                                 group_name=group)

    ws = [PreWorker.remote() for _ in range(2)]
    addrs = {r: rt.get(w.addr.remote(), timeout=60) for r, w in enumerate(ws)}
    g = "pre-dag-torch"
    assert rt.get([w.join.remote(2, r, addrs, g) for r, w in enumerate(ws)],
                  timeout=60) == [True] * 2
    out = rt.get([w.allreduce.remote([float(r), 1.0], g)
                  for r, w in enumerate(ws)], timeout=120)
    for o in out:
        np.testing.assert_allclose(o, [1.0, 2.0])
    keys = global_worker().kv("keys", ns="collective",
                              prefix=f"col/{g}/addr")["keys"]
    assert keys == []
    for w in ws:
        rt.kill(w)


def test_prenegotiated_group_validates_address_map(cluster):
    from ray_tpu_torch.util import collective as col

    with pytest.raises(ValueError, match="address map"):
        col.init_prenegotiated_group(2, 0, {0: ("h", 1)}, "pre-bad")
    with pytest.raises(ValueError, match="address map"):
        col.init_prenegotiated_group(2, 0, {0: ("h", 1), 2: ("h", 2)},
                                     "pre-bad2")


# ------------------------------------------------- OpenAI drop-in surface
def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_openai_serve_over_pipeline_engine(cluster):
    """build_openai_app(pipeline_stages=2) serves the golden model over
    HTTP through the pipeline: its greedy tokens are the JAX package's,
    and /v1/stats names 2 stages, each in a process of its own."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.openai import build_openai_app

    shape, tree, prompts, greedy = _golden()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    app = build_openai_app(LLMConfig(**shape, params=params_from_flax(tree)),
                           model_id="pp-llm", max_batch=4,
                           default_max_tokens=8, pipeline_stages=2,
                           device="cpu")
    serve.run(app, route_prefix="/", port=port)
    try:
        base = f"http://127.0.0.1:{port}"
        for prompt, want in zip(prompts, greedy):
            out = _post(f"{base}/v1/completions",
                        {"prompt": prompt, "max_tokens": len(want),
                         "temperature": 0.0})
            assert out["token_ids"] == want.tolist()
            assert out["choices"][0]["finish_reason"] == "length"
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["pipeline_stages"] == 2
        pids = {s["pid"] for s in stats["pipeline"]["stages"]}
        assert len(pids) == 2 and stats["pid"] not in pids
        assert os.getpid() not in pids
    finally:
        serve.shutdown()


# ------------------------------------------------------------ stage death
def _drain_bounded(stream, budget_s=60.0) -> list:
    """Drain a stream with a hard wall: a hang fails the test by name. A
    5 s wait without a token is not a failure (GenStream.next raises
    GetTimeoutError for it): a rebuild under load can take longer."""
    toks = []
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        try:
            toks.append(stream.next(timeout=5))
        except GetTimeoutError:
            continue
        except StopIteration:
            return toks
    pytest.fail(f"stream did not finish within {budget_s}s")


def test_stage_death_attributes_streams_then_engine_rebuilds(cluster):
    """Stage 1 killed with the runtime's `kill` while streams are open:
    every open stream ends with a DagStageError naming the stage, the
    engine rebuilds fresh stages, and the next request gets the tokens the
    model gave before the kill."""
    cfg = LLMConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                    max_seq=256)
    pipe = PipelinedEngine(cfg, n_stages=2, max_batch=4, microbatch=2,
                           device="cpu")
    try:
        warm = pipe.generate([[1, 2]], SamplingParams(temperature=0.0,
                                                      max_tokens=4))
        old_pids = [rt.get(a.pid.remote(), timeout=30) for a in pipe._actors]
        streams = [pipe.submit([1, 2, 3], SamplingParams(temperature=0.0,
                                                         max_tokens=200))
                   for _ in range(3)]
        streams[0].next(timeout=30)  # generation is live
        rt.kill(pipe._actors[1])
        for s in streams:
            with pytest.raises(DagStageError) as ei:
                _drain_bounded(s, budget_s=60.0)
            assert ei.value.stage == "step[1]", ei.value
            assert "died" in str(ei.value)
        again = pipe.submit([1, 2], SamplingParams(temperature=0.0,
                                                   max_tokens=4))
        assert _drain_bounded(again, budget_s=90.0) == warm[0]
        new_pids = [rt.get(a.pid.remote(), timeout=30) for a in pipe._actors]
        assert not set(new_pids) & set(old_pids)
        assert pipe.num_active == 0
    finally:
        pipe.shutdown()
    assert pipe._actors == [] and pipe._dag is None


def test_shutdown_mid_generation_never_hangs(cluster):
    """shutdown() with a stream open ends it promptly, and later submits
    are refused."""
    cfg = LLMConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                    max_seq=256)
    pipe = PipelinedEngine(cfg, n_stages=2, max_batch=4, microbatch=2,
                           device="cpu")
    s = pipe.submit([3, 4], SamplingParams(temperature=0.0, max_tokens=200))
    s.next(timeout=30)  # generation is live
    t0 = time.monotonic()
    pipe.shutdown()
    _drain_bounded(s, budget_s=30.0)
    assert time.monotonic() - t0 < 30.0
    with pytest.raises(RuntimeError, match="shut down"):
        pipe.submit([1], SamplingParams(max_tokens=2))
    assert pipe._actors == [] and pipe._dag is None

"""The port's sharded Transformer, tensor-parallel engine, sharded restore
and sharded training step held against the JAX package on the CPU.

The port's side runs in 4 rank processes (gloo, `file://` rendezvous;
`tests/torch_parallel_ranks.py`), spawned once for this file, and in a
2-worker `TorchTrainer`; the JAX side runs here on the 8-device CPU mesh
that conftest.py sets up (GSPMD with the reference's PartitionSpecs).
Everything is float32; the two sides differ in summation order only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import ray_tpu_torch as rt
import torch_parallel_ranks as ranks
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import ContinuousEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.llm.engine import model_config as jax_model_config
from ray_tpu.models import transformer as jtfm
from ray_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from ray_tpu.parallel.mesh import build_mesh as jax_build_mesh
from ray_tpu.train import checkpoint as jck
from ray_tpu_torch.llm import LLMConfig
from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              loss_fn, param_specs)
from ray_tpu_torch.parallel.dryrun import run_ranks
from ray_tpu_torch.parallel.mesh import P, devices_distinct
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.train import checkpoint as ck
from ray_tpu_torch.train._internal.worker_group import choose_torch_backend

DENSE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
             d_ff=172, max_seq=32)  # tests/test_parallel.py:72
MOE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
           d_ff=96, max_seq=32, moe_experts=4)  # tests/test_parallel.py:150
#: run -> (the port's mesh on 4 ranks, the JAX package's mesh on 8 devices,
#: model). At most 4 ranks: dp.sp2.tp2 runs with dp=1 here (dp is sharded
#: in the ep2 run), against the reference test's dp2.sp2.tp2.
RUNS = {
    "dp.sp2.tp2": (dict(dp=-1, sp=2, tp=2), dict(dp=2, sp=2, tp=2), DENSE),
    "fsdp2.tp2": (dict(dp=-1, fsdp=2, tp=2), dict(dp=-1, fsdp=2, tp=2), DENSE),
    "dp2.ep2.moe": (dict(dp=-1, ep=2), dict(dp=2, fsdp=2, ep=2), MOE),
}
ENGINE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, max_seq=64,
              dtype="float32")  # __graft_entry__.run_tp_generate's model
PROMPTS = [[1, 2, 3, 4], [5, 17, 250, 3, 99]]
MAX_TOKENS = 8
RESTORE_SPECS = {"w": P("tp", None), "b": P(None, "tp")}


def _jax_model(model_kwargs, seed=1):
    cfg = jtfm.TransformerConfig(**model_kwargs, dtype=jnp.float32)
    model = jtfm.Transformer(cfg)
    rng = jax.random.PRNGKey(seed)
    tokens = jax.random.randint(rng, (4, 17), 0, cfg.vocab_size,
                                dtype=jnp.int32)
    return model, model.init(rng, tokens[:, :-1]), tokens


def _jax_checkpoints(tmp):
    """The same state saved by the JAX package (w sharded over rows on 8
    devices: 8 shard boxes in the file) and by the port."""
    w = np.arange(16 * 6, dtype=np.float32).reshape(16, 6) / 7
    b = np.arange(4 * 6, dtype=np.int32).reshape(4, 6)
    mesh = JaxMesh(np.asarray(jax.devices()), ("x",))
    jw = jax.device_put(jnp.asarray(w), NamedSharding(mesh, JP("x", None)))
    dirs = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jck.save({"w": jw, "b": b, "step": 3}, dirs["jax"], step=3)
    ck.save({"w": torch.from_numpy(w), "b": torch.from_numpy(b), "step": 3},
            dirs["port"], step=3)
    return dirs, {"w": w, "b": b}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """One spawn of 4 ranks for every rank-side check of this file."""
    runs, jax_side = {}, {}
    for name, (port_mesh, jax_mesh, model_kwargs) in RUNS.items():
        model, params, tokens = _jax_model(model_kwargs)
        state = {k: v.numpy() for k, v in params_from_flax(
            jax.tree.map(np.asarray, params)).items()}
        runs[name] = (port_mesh, model_kwargs, state,
                      np.asarray(tokens, np.int64))
        jax_side[name] = (model, params, tokens, jax_mesh)
    jcfg = JaxLLMConfig(**ENGINE)
    flax = jtfm.Transformer(jax_model_config(jcfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    flax = jax.tree.map(np.asarray, flax)
    dirs, saved = _jax_checkpoints(tmp_path_factory.mktemp("ckpt"))
    out = run_ranks(ranks.parallel_checks, 4, runs,
                    (ENGINE, flax, PROMPTS, MAX_TOKENS),
                    (dirs, RESTORE_SPECS))
    return {"runs": runs, "jax": jax_side, "flax": flax, "saved": saved,
            "ranks": out}


# ------------------------------------------------------------ param_specs
@pytest.mark.parametrize("model_kwargs", [DENSE, MOE], ids=["dense", "moe"])
def test_param_specs_equal_the_reference_name_for_name(model_kwargs):
    _model, params, _tokens = _jax_model(model_kwargs)
    want_leaves, treedef = jax.tree_util.tree_flatten(
        jtfm.param_specs(params), is_leaf=lambda x: isinstance(x, JP))
    # the reference's spec of each port name: convert a tree of leaf indices
    index_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.asarray(i) for i in range(len(want_leaves))])
    names = {n: int(i) for n, i in params_from_flax(index_tree).items()}
    cfg = TransformerConfig(**model_kwargs, dtype=torch.float32)
    got = param_specs(Transformer(cfg, device="cpu").state_dict())
    assert set(got) == set(names)
    for name, spec in got.items():
        assert isinstance(spec, P)
        assert tuple(spec) == tuple(want_leaves[names[name]]), name


# ------------------------------------------------------ sharded training
def _jax_value_and_grad(model, params, tokens, mesh_sizes):
    mesh = jax_build_mesh(JaxMeshConfig(**mesh_sizes))
    shardings = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                       jtfm.param_specs(params))
    params_s = jax.tree_util.tree_map(jax.device_put, params, shardings)
    tokens_s = jax.device_put(tokens,
                              NamedSharding(mesh, JP(("dp", "fsdp"), None)))
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jtfm.loss_fn(model, p, t)))(params_s, tokens_s)
    return float(loss), params_from_flax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_loss_and_gradients_match_jax_sharded_value_and_grad(
        rank_results, run):
    """Every rank's loss equals JAX's sharded value_and_grad within 1e-5,
    and the gradient boxes, put together (replicated boxes checked equal on
    every rank), equal JAX's gradients within 2e-5 + 1e-4 * |ref| (f32,
    summation order)."""
    model, params, tokens, jax_mesh = rank_results["jax"][run]
    want_loss, want = _jax_value_and_grad(model, params, tokens, jax_mesh)
    got = {n: np.full(g.shape, np.nan, np.float32) for n, g in want.items()}
    for res in rank_results["ranks"]:
        r = res["model"][run]
        assert abs(r["loss"] - want_loss) < 1e-5, (r["loss"], want_loss)
        for name, (box, g) in r["grads"].items():
            sl = tuple(slice(a, b) for a, b in box)
            if not np.isnan(got[name][sl]).all():  # a replica's box
                np.testing.assert_allclose(g, got[name][sl], atol=1e-6,
                                           rtol=0, err_msg=name)
            got[name][sl] = g
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g.numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


# -------------------------------------------------------------- serving
def test_tp_engine_greedy_tokens_equal_the_jax_package_and_unsharded(
        rank_results):
    """run_tp_generate's model at tp=2: the port's engine (dp=2 replicas
    following rank 0) gives the greedy tokens of the JAX package's
    ContinuousEngine(mesh=tp2) and of the port's unsharded engine."""
    got = rank_results["ranks"][0]["engine"]
    assert all(r["engine"] is None for r in rank_results["ranks"][1:])
    flax = rank_results["flax"]
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("tp",))
    jeng = JaxEngine(JaxLLMConfig(**ENGINE, params=flax), max_batch=2,
                     decode_chunk=4, mesh=mesh)
    try:
        want = [s.tokens() for s in [jeng.submit(
            p, JaxSampling(temperature=0.0, max_tokens=MAX_TOKENS))
            for p in PROMPTS]]
    finally:
        jeng.shutdown()
    peng = ContinuousEngine(LLMConfig(**ENGINE, params=flax), max_batch=2,
                            decode_chunk=4, device="cpu")
    try:
        plain = [s.tokens() for s in [peng.submit(
            p, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
            for p in PROMPTS]]
    finally:
        peng.shutdown()
    assert got == want == plain
    assert all(len(t) == MAX_TOKENS for t in got)


def test_engine_refuses_a_sequence_parallel_mesh():
    class _Sp2:  # sizes only: the engine refuses before any collective
        def size(self, axis):
            return 2 if axis == "sp" else 1

    with pytest.raises(ValueError, match="tp only"):
        ContinuousEngine(LLMConfig(**ENGINE), mesh=_Sp2(), device="cpu")


def test_only_follower_ranks_follow_and_only_rank_0_shuts_down():
    """On a one-rank mesh the engine is rank 0's: follow() is refused. A
    follower's shutdown() is refused too: its engine stops with rank 0's."""
    from ray_tpu_torch.parallel.mesh import build_mesh

    eng = ContinuousEngine(LLMConfig(**ENGINE), mesh=build_mesh(), device="cpu")
    with pytest.raises(RuntimeError, match="only the other ranks"):
        eng.follow()
    eng.shutdown()
    eng._leader = False  # a follower's view of the same engine
    with pytest.raises(RuntimeError, match="call follow"):
        eng.shutdown()


@pytest.mark.parametrize("entry", ["sharded_step", "pipeline_step",
                                   "tp_generate", "pipeline_params"])
def test_parallel_entry_points_default_to_the_card(entry, monkeypatch):
    """Without device="cpu" the dryrun's paths and the pipeline's
    parameters ask for CUDA, and raise where there is none."""
    from ray_tpu_torch.parallel import dryrun, pipeline
    from ray_tpu_torch.parallel.mesh import MeshConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    call = {"sharded_step": lambda: dryrun.run_sharded_step(
                0, MeshConfig(dp=1), "dp"),
            "pipeline_step": lambda: dryrun.run_pipeline_step(0, 1, "pp1"),
            "tp_generate": lambda: dryrun.run_tp_generate(0, 1, "tp1"),
            "pipeline_params": lambda: pipeline.init_params(
                pipeline.PipelineConfig())}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


# ------------------------------------------------------- sharded restore
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("form", ["dict", "spec", "callable"])
def test_sharded_restore_gives_each_rank_its_box(rank_results, writer, form):
    """A checkpoint written by the JAX package (w in 8 row shards) or by
    the port, restored onto a tp=2 mesh: each rank gets its block of each
    leaf under the spec (dict by path, one spec, or a callable), and the
    non-array leaf whole."""
    saved = rank_results["saved"]
    specs = RESTORE_SPECS if form != "spec" else {"w": P(None, "tp"),
                                                  "b": P(None, "tp")}
    for res in rank_results["ranks"]:
        t = res["restore"]["tp"]
        got = res["restore"][writer, form]
        assert got["step"] == 3
        for name, full in saved.items():
            spec = specs[name]
            box = [slice(None)] * 2
            d = spec.index("tp")
            n = full.shape[d] // 2
            box[d] = slice(t * n, (t + 1) * n)
            want = full[tuple(box)]
            assert got[name].dtype == want.dtype
            assert np.array_equal(got[name], want), (writer, form, name)


def test_restore_with_shardings_needs_a_mesh(tmp_path):
    ck.save({"w": torch.zeros(2, 2)}, str(tmp_path / "c"), step=0)
    with pytest.raises(ValueError, match="need a mesh"):
        ck.restore(str(tmp_path / "c"), shardings=P("tp"))


# ------------------------------------------- backend and sharded trainer
@pytest.mark.parametrize("devices,backend", [
    ([None, None], "gloo"),  # CPU workers
    (["GPU-a", "GPU-a"], "gloo"),  # two workers sharing one card
    (["GPU-a", "GPU-b"], "nccl"),  # a card each
])
def test_torch_backend_follows_device_distinctness(devices, backend):
    assert choose_torch_backend(devices) == backend
    assert devices_distinct(devices) == (backend == "nccl")


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_torch_trainer_runs_the_tp2_step_on_a_global_mesh(cluster, tmp_path):
    """Two CPU workers with torch_distributed=True: each builds a tp=2 mesh
    over the trainer's process group (global_mesh_from_distributed) and
    takes one sharded Adam step; the loss equals the unsharded model's and
    each rank's box of wq's gradient is the unsharded gradient's box."""
    model_kwargs = dict(DENSE, moe_experts=0)
    tokens = np.random.RandomState(3).randint(
        0, DENSE["vocab_size"], (4, 17)).astype(np.int64)
    result = TorchTrainer(
        ranks.tp_train_loop,
        train_loop_config={"cfg": model_kwargs, "tokens": tokens},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     torch_distributed=True),
        run_config=RunConfig(name="tp2", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    reports = sorted(result.metrics_history, key=lambda m: m["tp"])
    assert [m["tp"] for m in reports] == [0, 1]
    assert {m["backend"] for m in reports} == {"gloo"}
    ref = Transformer(TransformerConfig(**model_kwargs, dtype=torch.float32),
                      device="cpu", seed=0)
    loss = loss_fn(ref, torch.from_numpy(tokens))
    loss.backward()
    want = ref.layers[0].attn.wq.grad.numpy()
    for m in reports:
        assert abs(m["loss"] - loss.item()) < 1e-5
        sl = tuple(slice(a, b) for a, b in m["wq_box"])
        np.testing.assert_allclose(m["wq_grad"], want[sl], atol=2e-5,
                                   rtol=1e-4)

"""The port's collectives, sequence parallelism and pipeline schedule held
against the JAX package on the CPU.

The port's side runs in 4 rank processes (gloo, `file://` rendezvous;
`tests/torch_parallel_ranks.py`), spawned once for this file; the JAX
side runs here on the 8-device CPU mesh that conftest.py sets up, under
`shard_map`. Inputs come from numpy seeds. Everything is float32.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import torch_parallel_ranks as ranks
from ray_tpu.ops.attention import _xla_attention
from ray_tpu.ops.ring_attention import ring_attention as jax_ring
from ray_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel.collectives import shard_map
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel.dryrun import run_ranks

# Both sides compute in f32 and differ in summation order only.
ATOL = 2e-5
PIPE = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, d_ff=128,
            n_microbatches=4)


def _jax_mesh(axes: dict) -> JaxMesh:
    shape = tuple(axes.values())
    return JaxMesh(np.asarray(jax.devices()[:4]).reshape(shape), tuple(axes))


def _jax_collective(name):
    """(jax function, in spec, out spec, check_vma) of one case: the same
    collective under shard_map."""
    lax = jax.lax
    i, ab, ba = JP("i"), JP(("a", "b")), JP(("b", "a"))
    return {
        "psum": (lambda x: lax.psum(x, "i"), i, JP(), False),
        "pmean": (lambda x: lax.pmean(x, "i"), i, JP(), False),
        "pvary": (lambda x: lax.pcast(x, "i", to="varying"), JP(), i, True),
        "all_gather": (lambda x: lax.all_gather(x, "i", tiled=True), i, i,
                       False),
        "all_gather_dim1": (lambda x: lax.all_gather(x, "i", axis=1,
                                                     tiled=True), i, i, False),
        "all_gather_untiled": (lambda x: lax.all_gather(x, "i", axis=0), i, i,
                               False),
        "all_gather_invariant": (lambda x: lax.all_gather(x, "i", tiled=True),
                                 i, JP(), False),
        "psum_scatter": (lambda x: lax.psum_scatter(x, "i", tiled=True), i, i,
                         False),
        "ppermute_ring": (lambda x: lax.ppermute(
            x, "i", [(j, (j + 1) % 4) for j in range(4)]), i, i, False),
        "ppermute_line": (lambda x: lax.ppermute(
            x, "i", [(0, 1), (1, 2), (2, 3)]), i, i, False),
        "all_to_all": (lambda x: lax.all_to_all(x, "i", 1, 0, tiled=True), i,
                       i, False),
        "psum_tuple": (lambda x: lax.psum(x, ("a", "b")), ab, JP(), False),
        "all_gather_tuple": (lambda x: lax.all_gather(x, ("a", "b"),
                                                      tiled=True), ab, ab,
                             False),
        "psum_scatter_tuple": (lambda x: lax.psum_scatter(
            x, ("a", "b"), tiled=True), ab, ab, False),
        "all_gather_tuple_reversed": (lambda x: lax.all_gather(
            x, ("b", "a"), tiled=True), ba, ba, False),
        "psum_scatter_tuple_reversed": (lambda x: lax.psum_scatter(
            x, ("b", "a"), tiled=True), ba, ba, False),
    }[name]


def _collective_case(name, rng):
    """Global input, global output, cotangent and JAX's vjp of one case."""
    axes, _fn, sharded = ranks.COLLECTIVES[name]
    fn, in_spec, out_spec, check = _jax_collective(name)
    rows = 8 if sharded else 2
    if name.startswith("psum_scatter"):
        rows = 32  # each rank's block must split 4 ways
    x = rng.randn(rows, 8 if name == "all_to_all" else 4).astype(np.float32)
    mesh = _jax_mesh(axes)
    f = shard_map(fn, mesh=mesh, in_specs=in_spec, out_specs=out_spec,
                  check_vma=check)
    y, vjp = jax.vjp(f, jnp.asarray(x))
    ct = rng.randn(*y.shape).astype(np.float32)
    (grad,) = vjp(jnp.asarray(ct))
    y, grad = np.asarray(y), np.asarray(grad)
    # each rank's cotangent: its block of a sharded output, the whole of a
    # replicated one
    cts = [ct] * 4 if out_spec == JP() else \
        [np.split(ct, 4)[ranks.block_of_rank(name, r)] for r in range(4)]
    return x, y, cts, grad, out_spec == JP(), sharded


@pytest.fixture(scope="module")
def rank_results():
    """One spawn of 4 ranks for every check of this file."""
    rng = np.random.RandomState(0)
    coll = {name: _collective_case(name, rng) for name in ranks.COLLECTIVES}
    allreduce_x = rng.randn(8, 3).astype(np.float32)
    sp_cases = {}
    srng = np.random.RandomState(2)
    for kind, hq, hkv in (("ring", 2, 2), ("ring", 4, 2), ("ulysses", 4, 4)):
        for causal in (True, False):
            q = srng.randn(2, 64, hq, 16).astype(np.float32)
            k = srng.randn(2, 64, hkv, 16).astype(np.float32)
            v = srng.randn(2, 64, hkv, 16).astype(np.float32)
            sp_cases[f"{kind}-hq{hq}-hkv{hkv}-causal{causal}"] = (
                kind, causal, q, k, v)
    tokens = np.random.RandomState(0).randint(
        0, PIPE["vocab_size"], (8, 17)).astype(np.int64)
    inputs = {n: (c[0], c[2]) for n, c in coll.items()}
    inputs["mesh_allreduce"] = allreduce_x
    out = run_ranks(ranks.sp_checks, 4, inputs, sp_cases, PIPE, tokens)
    return {"coll": coll, "allreduce_x": allreduce_x, "sp": sp_cases,
            "tokens": tokens, "ranks": out}


@pytest.mark.parametrize("name", sorted(ranks.COLLECTIVES))
def test_collective_and_its_gradient_match_shard_map_vjp(rank_results, name):
    """Each rank's output is its block of shard_map's global output (the
    whole of it where the output is replicated), and its gradient its block
    of jax.vjp's (the whole where the input is replicated)."""
    x, y, _cts, grad, out_replicated, in_sharded = rank_results["coll"][name]
    for r, res in enumerate(rank_results["ranks"]):
        got_y, got_grad = res["coll"][name]
        block = ranks.block_of_rank(name, r)
        want_y = y if out_replicated else np.split(y, 4)[block]
        np.testing.assert_allclose(got_y, want_y, atol=ATOL, rtol=0)
        want_grad = np.split(grad, 4)[block] if in_sharded else grad
        np.testing.assert_allclose(got_grad, want_grad, atol=ATOL, rtol=0)


def test_mesh_allreduce_sums_the_shards(rank_results):
    want = np.split(rank_results["allreduce_x"], 4)
    for res in rank_results["ranks"]:
        np.testing.assert_allclose(res["coll"]["mesh_allreduce"], sum(want),
                                   atol=ATOL, rtol=0)


def _jax_sp(kind, causal, q, k, v):
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("sp",))
    fn = jax_ring if kind == "ring" else jax_ulysses
    f = shard_map(lambda q, k, v: fn(q, k, v, axis_name="sp", causal=causal),
                  mesh=mesh, in_specs=(JP(None, "sp"),) * 3,
                  out_specs=JP(None, "sp"))
    return np.asarray(jax.jit(f)(q, k, v))


@pytest.mark.parametrize("case", [
    f"{kind}-hq{hq}-hkv{hkv}-causal{causal}"
    for kind, hq, hkv in (("ring", 2, 2), ("ring", 4, 2), ("ulysses", 4, 4))
    for causal in (True, False)])
def test_sequence_parallel_attention_matches_the_jax_package(rank_results,
                                                             case):
    """Ring (GQA folded) and Ulysses attention over sp=4 at the shapes of
    tests/test_ops.py: the gathered output equals the JAX package's
    shard_map'd op and full attention within 2e-5."""
    kind, causal, q, k, v = rank_results["sp"][case]
    got = np.concatenate([r["sp"][case] for r in rank_results["ranks"]],
                         axis=1)
    np.testing.assert_allclose(got, _jax_sp(kind, causal, q, k, v),
                               atol=ATOL, rtol=0)
    full = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=0)


def test_ulysses_rejects_heads_that_do_not_divide():
    """The reference's error, raised before any collective (so a stand-in
    that only knows the axis size will do)."""
    from ray_tpu_torch.ops import ulysses_attention

    four_way = types.SimpleNamespace(size=lambda axis: 4)
    q = torch.zeros(1, 8, 6, 4)
    with pytest.raises(ValueError, match="divisible by the axis size"):
        ulysses_attention(q, q, q, axis_name="sp", mesh=four_way)


def test_pipeline_params_equal_the_jax_package():
    cfg = jpipe.PipelineConfig(**PIPE)
    want = jax.tree_util.tree_leaves(jpipe.init_params(cfg))
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(),
                               tpipe.init_params(tpipe.PipelineConfig(**PIPE),
                                                 device="cpu")))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))


def test_pipeline_loss_and_gradients_match_the_jax_package(rank_results):
    """GPipe over pp=2: the loss and every gradient (stage blocks gathered
    over pp) equal `pipeline_loss_fn`'s value_and_grad."""
    cfg = jpipe.PipelineConfig(**PIPE)
    params = jpipe.init_params(cfg)
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("pp",))
    tokens = jnp.asarray(rank_results["tokens"], jnp.int32)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            jpipe.pipeline_loss_fn(cfg, mesh)))(params, tokens)
    res = sorted((r["pipe"] for r in rank_results["ranks"]),
                 key=lambda r: r["stage"])
    for r in res:
        assert abs(r["loss"] - float(loss)) < 1e-5
    want = {"emb": grads["emb"], "final_norm": grads["final_norm"],
            **{f"blocks/{k}": v for k, v in grads["blocks"].items()}}
    for name, g in want.items():
        if name.startswith("blocks/"):
            got = np.concatenate([res[0]["grads"][name],
                                  res[-1]["grads"][name]])
        else:
            got = res[0]["grads"][name]
            for r in res:  # replicated: equal on every stage
                np.testing.assert_allclose(r["grads"][name], got, atol=ATOL,
                                           rtol=0)
        np.testing.assert_allclose(got, np.asarray(g), atol=ATOL, rtol=0)


def test_dryrun_multichip_on_four_cpu_ranks():
    """The port's dryrun_multichip(4): every reference configuration for 4
    ranks, each within the reference's tolerance of its unsharded twin."""
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.parallel.dryrun", "4", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-3000:]
    for label in ("dp.sp2.tp2", "fsdp2.tp2", "ep2.moe", "pp2.pipeline",
                  "tp4.llm.generate"):
        assert f"dryrun[{label}]" in r.stdout and "OK" in r.stdout
    assert "dryrun_multichip(4) OK" in r.stdout

"""`TorchTrainer` on the port's runtime, on the CPU (`use_gpu=False`):
the MNIST MLP on 2 workers held to `jax.value_and_grad` at step 0, a
2-worker DP step against a 1-worker step on the whole batch, restart from
the async checkpoint after a worker dies, no retry of a user error,
dataset shards, a gloo `torch.distributed` group, the refusal of
`use_gpu=True` where the cluster counts no GPU, and a small Transformer
trained in a worker against the port's in-process loop and JAX's loss.

Counterpart tests: tests/test_train.py. The JAX side is held in process
(`jax.value_and_grad`), never as a running `JaxTrainer`: two runtimes do
not share a test process. The module brings its own cluster.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models.mlp import MLP as JaxMLP
from ray_tpu.models.mlp import loss_fn as jax_mlp_loss
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import loss_fn as jax_loss_fn
from ray_tpu_torch import data as rd
from ray_tpu_torch.models.convert import mlp_params_from_flax, params_from_flax
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)
from ray_tpu_torch.train import checkpoint as ck

CPU = ScalingConfig(num_workers=1, use_gpu=False)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _shard(rank, batch):
    rng = np.random.RandomState(rank)
    x = rng.rand(batch, 28, 28).astype("float32")
    y = (rng.rand(batch) * 10).astype("int32")
    return x, y


def _host(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def mnist_loop(config):
    """The MLP from the driver's weights, Adam(1e-2), each rank on its own
    shard, gradients averaged over the group."""
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models.mlp import MLP, loss_fn
    from ray_tpu_torch.train import torch_utils

    ctx = train.get_context()
    rank = ctx.get_world_rank()
    x, y = (torch.from_numpy(a) for a in _shard(rank, config["batch"]))
    model = MLP(28 * 28, hidden=32, device="cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in config["weights"].items()})
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ck.restore(ckpt.path, device="cpu")
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optim"])
        start = state["step"] + 1
    for step in range(start, config["steps"]):
        opt.zero_grad()
        loss = loss_fn(model, (x, y))
        loss.backward()
        grads = torch_utils.sync_gradients(
            {n: p.grad for n, p in model.named_parameters()})
        for n, p in model.named_parameters():
            p.grad = grads[n]
        opt.step()
        if (config.get("die_at") == step and rank == 0
                and train.get_session().restart_index == 0):
            os._exit(1)  # simulated worker crash (first attempt only)
        metrics = {"loss": loss.item(), "step": step, "rank": rank,
                   "attempt": train.get_session().restart_index}
        if step == 0:
            metrics["grads"] = _host(grads)
        # A state checkpoint is sharded: every rank reports it, rank 0
        # commits once every rank's shards have landed.
        train.report(metrics, checkpoint={"model": model.state_dict(),
                                          "optim": opt.state_dict(),
                                          "step": step})


def _jax_mlp():
    model = JaxMLP(hidden=32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28)))
    weights = {k: v.numpy() for k, v in mlp_params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    return model, params, weights


def test_mnist_2workers_match_jax_at_step_0(cluster, tmp_path):
    jmodel, params, weights = _jax_mlp()
    result = TorchTrainer(
        mnist_loop,
        train_loop_config={"batch": 64, "steps": 12, "weights": weights},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="mnist", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    by = {(m["rank"], m["step"]): m for m in hist}
    assert len(by) == 24
    ref_losses, ref_grads = [], []
    for rank in range(2):
        x, y = _shard(rank, 64)
        loss, g = jax.value_and_grad(lambda p: jax_mlp_loss(
            jmodel, p, (jnp.asarray(x), jnp.asarray(y))))(params)
        ref_losses.append(float(loss))
        ref_grads.append(mlp_params_from_flax(jax.tree.map(np.asarray, g)))
        assert by[(rank, 0)]["loss"] == pytest.approx(float(loss), abs=1e-5)
    for rank in range(2):
        for name, g in by[(rank, 0)]["grads"].items():
            want = (ref_grads[0][name] + ref_grads[1][name]).numpy() / 2
            np.testing.assert_allclose(g, want, atol=1e-5, rtol=0,
                                       err_msg=name)
    mean = lambda s: (by[(0, s)]["loss"] + by[(1, s)]["loss"]) / 2  # noqa: E731
    assert mean(11) < mean(0)
    state = ck.restore(result.checkpoint.path, device="cpu")
    assert state["step"] == 11
    assert set(state["model"]) == set(weights)


def dp_loop(config):
    """One SGD step on this rank's rows of the batch; report the
    parameters after it."""
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models.mlp import MLP, loss_fn
    from ray_tpu_torch.train import torch_utils

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    x, y = _shard(0, config["batch"])
    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    model = MLP(28 * 28, hidden=32, device="cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in config["weights"].items()})
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    loss_fn(model, (torch.from_numpy(x[rows]),
                    torch.from_numpy(y[rows]))).backward()
    grads = torch_utils.sync_gradients(
        {n: p.grad for n, p in model.named_parameters()})
    for n, p in model.named_parameters():
        p.grad = grads[n]
    opt.step()
    train.report({"rank": rank, "params": _host(model.state_dict())})


def test_two_worker_dp_step_equals_one_worker_step(cluster, tmp_path):
    _, _, weights = _jax_mlp()
    out = {}
    for n in (1, 2):
        result = TorchTrainer(
            dp_loop, train_loop_config={"batch": 64, "weights": weights},
            scaling_config=ScalingConfig(num_workers=n, use_gpu=False),
            run_config=RunConfig(name=f"dp{n}", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is None, result.error
        out[n] = [m["params"] for m in result.metrics_history]
    assert len(out[2]) == 2
    for params in out[2]:
        for name, want in out[1][0].items():
            np.testing.assert_allclose(params[name], want, atol=1e-6, rtol=0,
                                       err_msg=name)


def test_failure_restart_resumes_from_the_async_checkpoint(cluster, tmp_path):
    _, _, weights = _jax_mlp()
    result = TorchTrainer(
        mnist_loop,
        train_loop_config={"batch": 32, "steps": 6, "die_at": 3,
                           "weights": weights},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="ft", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert result.error is None, result.error
    state = ck.restore(result.checkpoint.path, device="cpu")
    assert state["step"] == 5
    assert {m["attempt"] for m in result.metrics_history} <= {0, 1}
    # The restart resumes after the last checkpoint the controller saw
    # committed: each report is released with its checkpoint's commit, so
    # that is the last step rank 0's first attempt reported (saves are
    # async, so how far they got before the crash varies).
    first = sorted(m["step"] for m in result.metrics_history
                   if m["attempt"] == 0 and m["rank"] == 0)
    resumed = sorted(m["step"] for m in result.metrics_history
                     if m["attempt"] == 1 and m["rank"] == 0)
    assert len(first) <= 3 and first == list(range(len(first)))
    assert resumed == list(range(len(first), 6))


def test_user_error_is_not_retried(cluster, tmp_path):
    calls = str(tmp_path / "calls")

    def bad_loop(config):
        with open(config["calls"], "a") as f:
            f.write("x")
        raise ValueError("intentional")

    result = TorchTrainer(
        bad_loop, train_loop_config={"calls": calls}, scaling_config=CPU,
        run_config=RunConfig(name="bad", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=3)),
    ).fit()
    assert result.error is not None and "intentional" in result.error
    with open(calls) as f:
        assert f.read() == "x"


def shard_loop():
    import ray_tpu_torch.train as train

    ids = []
    for batch in train.get_dataset_shard("train").iter_batches(batch_size=7):
        ids.extend(int(i) for i in batch["id"])
    train.report({"rank": train.get_context().get_world_rank(), "ids": ids})


def test_dataset_shards_are_disjoint_and_cover(cluster, tmp_path):
    result = TorchTrainer(
        shard_loop, datasets={"train": rd.range(40, parallelism=4)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="shards", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    ids = {m["rank"]: m["ids"] for m in result.metrics_history}
    assert len(ids[0]) == len(ids[1]) == 20
    assert sorted(ids[0] + ids[1]) == list(range(40))


def dist_loop():
    import torch
    import torch.distributed as dist

    import ray_tpu_torch.train as train

    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    train.report({"sum": float(t[0]), "world": dist.get_world_size(),
                  "backend": dist.get_backend()})


def test_torch_distributed_gloo_group(cluster, tmp_path):
    result = TorchTrainer(
        dist_loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     torch_distributed=True),
        run_config=RunConfig(name="dist", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert [m["sum"] for m in result.metrics_history] == [1.0, 1.0]
    assert {m["backend"] for m in result.metrics_history} == {"gloo"}


def test_use_gpu_without_a_gpu_raises_at_once(cluster, tmp_path):
    assert rt.cluster_resources().get("GPU", 0) == 0
    trainer = TorchTrainer(lambda: None, scaling_config=ScalingConfig(),
                           run_config=RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(RuntimeError, match="use_gpu"):
        trainer.fit()


SHAPE = dict(vocab_size=320, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
             d_ff=160, max_seq=64)


def _tokens(step):
    return np.random.RandomState(100 + step).randint(
        0, SHAPE["vocab_size"], (2, 33)).astype(np.int64)


def transformer_steps(weights, steps):
    """Adam steps of the port's Transformer on the CPU; the losses."""
    import torch

    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn)

    model = Transformer(TransformerConfig(**SHAPE, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for step in range(steps):
        opt.zero_grad()
        loss = loss_fn(model, torch.from_numpy(_tokens(step)))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def transformer_loop(config):
    import ray_tpu_torch.train as train

    for step, loss in enumerate(transformer_steps(config["weights"], 3)):
        train.report({"step": step, "loss": loss})


def test_transformer_in_a_worker_matches_in_process_and_jax(cluster, tmp_path):
    jmodel = JaxTransformer(JaxConfig(**SHAPE, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    weights = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    result = TorchTrainer(
        transformer_loop, train_loop_config={"weights": weights},
        scaling_config=CPU,
        run_config=RunConfig(name="lm", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    got = [m["loss"] for m in result.metrics_history]
    want = transformer_steps(weights, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ref0 = float(jax_loss_fn(jmodel, params, jnp.asarray(_tokens(0),
                                                         jnp.int32)))
    assert got[0] == pytest.approx(ref0, abs=1e-5)

"""The golden file that `chip_smoke.py` phase 13 (a) holds the port's rllib
learners to on the card.

`tests/data/torch_port_rllib_golden.npz` carries the JAX package's
learners at seed 0 on seeded numpy inputs (every tree in flax layout):
- `policy_init/`: `RLModule.init(PRNGKey(0))` for CartPole (4 -> 64 ->
  64 -> 2 + 1), the weights the reference's PPO and IMPALA tests start
  from; `dqn/init/`: `DQNLearner(seed=0)`'s `QNet`, the reference DQN
  test's.
- PPO (default `PPOLearnerConfig`): `_loss` and its gradients on the
  first 128 rows of a seeded batch of 1024 (2 runners x 8 envs x 64
  steps, the main path's), the permutations its first `update` draws
  (`ppo/perms`), and the parameters and stats after that update.
- IMPALA (default config): V-trace's vs and pg_advantages, the loss and
  its gradients, and one update, on a seeded T16 x N8 batch.
- DQN (default config): the loss, |td| and gradients on a seeded batch
  of 128 with importance weights, and one update.
The card cannot run JAX, so the file is the reference there; these tests
recompute it with the JAX package and with the port on the CPU (through
`chip_smoke.rllib_golden_outputs`, the function phase 13 runs on the
card), so it cannot drift from either.

Regenerate with: JAX_PLATFORMS=cpu python tests/test_torch_rllib_golden.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ray_tpu.rllib import dqn as jax_dqn  # noqa: E402
from ray_tpu.rllib.impala import (IMPALALearner,  # noqa: E402
                                  IMPALALearnerConfig)
from ray_tpu.rllib.learner import PPOLearner, PPOLearnerConfig  # noqa: E402
from ray_tpu.rllib.rl_module import RLModule, RLModuleSpec  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_rllib_golden.npz")
SPEC = RLModuleSpec(observation_dim=4, action_dim=2)


def _flat(prefix: str, tree) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(f"{prefix}{k}/", v))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def golden_inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    n, T, N, B = 1024, 16, 8, 128
    return {
        "ppo/batch/obs": rng.randn(n, 4).astype(np.float32),
        "ppo/batch/actions": rng.randint(0, 2, n).astype(np.int32),
        "ppo/batch/logp_old": (np.log(0.5) + 0.1 * rng.randn(n)
                               ).astype(np.float32),
        "ppo/batch/advantages": rng.randn(n).astype(np.float32),
        "ppo/batch/value_targets": (5 * rng.rand(n)).astype(np.float32),
        "impala/batch/obs": rng.randn(T, N, 4).astype(np.float32),
        "impala/batch/actions": rng.randint(0, 2, (T, N)).astype(np.int32),
        "impala/batch/logp_old": (np.log(0.5) + 0.3 * rng.randn(T, N)
                                  ).astype(np.float32),
        "impala/batch/rewards": np.ones((T, N), np.float32),
        "impala/batch/dones": (rng.rand(T, N) < 0.1).astype(np.float32),
        "impala/batch/last_obs": rng.randn(N, 4).astype(np.float32),
        "dqn/batch/obs": rng.randn(B, 4).astype(np.float32),
        "dqn/batch/actions": rng.randint(0, 2, B).astype(np.int32),
        "dqn/batch/rewards": np.ones(B, np.float32),
        "dqn/batch/next_obs": rng.randn(B, 4).astype(np.float32),
        "dqn/batch/dones": (rng.rand(B) < 0.1).astype(np.float32),
        "dqn/weights": rng.uniform(0.2, 1.0, B).astype(np.float32),
    }


def _batch(g: dict, prefix: str) -> dict:
    return {k[len(prefix):]: jnp.asarray(v) for k, v in g.items()
            if k.startswith(prefix)}


def _jax_golden(g: dict) -> dict:
    out = {}
    # PPO: the learner the reference test builds at seed 0
    ppo = PPOLearner(RLModule(SPEC), PPOLearnerConfig(), seed=0)
    out.update(_flat("policy_init/", ppo.params["params"]))
    batch = _batch(g, "ppo/batch/")
    mb = {k: v[:128] for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(ppo._loss, has_aux=True)(
        ppo.params, mb)
    out["ppo/loss"] = np.float32(loss)
    out.update({f"ppo/aux/{k}": np.float32(v) for k, v in aux.items()})
    out.update(_flat("ppo/grad/", grads["params"]))
    _, sub = jax.random.split(jax.random.PRNGKey(0 + 1))  # update()'s key
    n = batch["obs"].shape[0]
    out["ppo/perms"] = np.stack([
        np.asarray(jax.random.permutation(e, n), np.int32)
        for e in jax.random.split(sub, ppo.cfg.num_epochs)])
    params, _, stats = ppo._update(ppo.params, ppo.opt_state, batch, sub)
    out.update(_flat("ppo/after/", params["params"]))
    out.update({f"ppo/stats/{k}": np.float32(v) for k, v in stats.items()})
    # IMPALA
    imp = IMPALALearner(RLModule(SPEC), IMPALALearnerConfig(), seed=0)
    batch = _batch(g, "impala/batch/")
    T, N = batch["obs"].shape[:2]
    logits, values = imp.module.forward_train(
        imp.params, batch["obs"].reshape(T * N, -1))
    logp = jnp.take_along_axis(jax.nn.log_softmax(logits.reshape(T, N, -1)),
                               batch["actions"][..., None], axis=-1)[..., 0]
    _, last_value = imp.module.forward_train(imp.params, batch["last_obs"])
    vs, pg = imp._vtrace(values.reshape(T, N), last_value, batch["rewards"],
                         batch["dones"], jnp.exp(logp - batch["logp_old"]))
    out["impala/vs"], out["impala/pg_adv"] = np.asarray(vs), np.asarray(pg)
    (loss, _), grads = jax.value_and_grad(imp._loss, has_aux=True)(
        imp.params, batch)
    out["impala/loss"] = np.float32(loss)
    out.update(_flat("impala/grad/", grads["params"]))
    params, _, _ = imp._update(imp.params, imp.opt_state, batch)
    out.update(_flat("impala/after/", params["params"]))
    # DQN: the loss is a closure of the jitted update
    dqn = jax_dqn.DQNLearner(SPEC, jax_dqn.DQNLearnerConfig(), seed=0)
    out.update(_flat("dqn/init/", dqn.params["params"]))
    inner = dqn._update.__wrapped__
    loss_fn = dict(zip(inner.__code__.co_freevars,
                       (c.cell_contents for c in inner.__closure__)))["loss_fn"]
    batch = _batch(g, "dqn/batch/")
    w = jnp.asarray(g["dqn/weights"])
    (loss, td), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        dqn.params, dqn.target_params, batch, w)
    out["dqn/loss"] = np.float32(loss)
    out["dqn/abs_td"] = np.abs(np.asarray(td))
    out.update(_flat("dqn/grad/", grads["params"]))
    dqn.update({k: np.asarray(v) for k, v in batch.items()}, g["dqn/weights"])
    out.update(_flat("dqn/after/", dqn.params["params"]))
    return out


def write_golden(path: str = GOLDEN) -> None:
    arrays = golden_inputs()
    arrays.update(_jax_golden(arrays))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_golden_inputs_are_the_seeded_draw(golden):
    for k, v in golden_inputs().items():
        np.testing.assert_array_equal(golden[k], v, err_msg=k)


def test_golden_matches_jax_package(golden):
    """The file is the JAX package's output: permutations exactly, every
    other array to 1e-6 of its largest magnitude (XLA's CPU code may
    differ between hosts in the last bits)."""
    ref = _jax_golden(golden)
    assert set(ref) | set(golden_inputs()) == set(golden)
    np.testing.assert_array_equal(ref["ppo/perms"], golden["ppo/perms"])
    for k, v in ref.items():
        np.testing.assert_allclose(
            v, golden[k], rtol=0, atol=1e-6 * max(1.0, np.abs(v).max()),
            err_msg=k)


def test_golden_matches_port_on_cpu(golden):
    """The port's learners on the file's inputs, on the CPU, through the
    function phase 13 (a) runs on the card, at the tolerances it holds
    there (`chip_smoke.RLLIB_GOLDEN_TOL`)."""
    out = chip_smoke.rllib_golden_outputs(golden, "cpu")
    worst = chip_smoke.rllib_golden_check(golden, out)
    assert set(worst) == {"ppo", "impala", "dqn"}


if __name__ == "__main__":
    write_golden()
    with np.load(GOLDEN) as f:
        print(f"wrote {GOLDEN}: {len(f.files)} arrays")

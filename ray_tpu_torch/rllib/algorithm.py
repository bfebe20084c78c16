"""Algorithm + PPO: the training driver.

Parity target: reference rllib/algorithms/algorithm.py:208 (Algorithm —
config.build() -> .train() iterations) + algorithms/ppo/ppo.py. The
structure mirrors the reference new API stack: EnvRunnerGroup actors
sample in parallel, the local Learner (jit'd, accelerator-resident)
updates, weights broadcast back. Also a Tune trainable: Algorithm exposes
step-wise train() so tune schedulers can early-stop it.

Counterpart: ray_tpu/rllib/algorithm.py (copied, with the port's device
rule): `AlgorithmConfig.device` (default "cuda", resolved when the
Algorithm is built, so a missing card raises before any actor starts) is
the learner's device, and `EnvRunnerGroup` builds its runners with
device="cpu", as the JAX package's runner actors ask for a CPU and no
chip. Weights travel to the runners as numpy arrays.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import (PPOLearner, PPOLearnerConfig,
                                         compute_gae)
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec


@dataclass
class AlgorithmConfig:
    """reference algorithm_config.py builder (environment()/env_runners()/
    training() chainers)."""

    env: Any = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 8
    rollout_fragment_length: int = 64
    seed: int = 0
    module_hidden: tuple = (64, 64)
    #: the learner's device; env runners always run on the CPU
    device: str = "cuda"

    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def build(self) -> "Algorithm":
        raise NotImplementedError


@dataclass
class PPOConfig(AlgorithmConfig):
    learner: PPOLearnerConfig = field(default_factory=PPOLearnerConfig)

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 clip: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 minibatch_size: Optional[int] = None) -> "PPOConfig":
        kw = {k: v for k, v in dict(
            lr=lr, gamma=gamma, clip=clip, entropy_coeff=entropy_coeff,
            num_epochs=num_epochs, minibatch_size=minibatch_size).items()
            if v is not None}
        self.learner = replace(self.learner, **kw)
        return self

    def build(self) -> "PPO":
        return PPO(copy.deepcopy(self))


class EnvRunnerGroup:
    """reference env_runner_group.py:71 — the actor fleet."""

    def __init__(self, config: AlgorithmConfig, module_spec: RLModuleSpec):
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(SingleAgentEnvRunner)
        self.runners = [
            runner_cls.remote(config.env, config.num_envs_per_env_runner,
                              module_spec, seed=config.seed + 1000 * i,
                              device="cpu")
            for i in range(config.num_env_runners)
        ]

    def sync_weights(self, weights):
        ray_tpu_torch.get(
            [r.set_weights.remote(weights) for r in self.runners],
            timeout=120)

    def sample(self, num_steps: int) -> list[dict]:
        return ray_tpu_torch.get(
            [r.sample.remote(num_steps) for r in self.runners], timeout=300)

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass


class Algorithm:
    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.iteration = 0

    def _bootstrap(self, make_learner):
        """Shared setup for concrete algorithms: probe the env for the
        module spec, build module + learner (via make_learner(module)) and
        the env-runner fleet."""
        config = self.config
        probe = make_vec_env(config.env, 1, seed=0)
        self.module_spec = RLModuleSpec(
            observation_dim=probe.observation_dim,
            action_dim=probe.action_dim,
            hidden=tuple(config.module_hidden))
        self.module = RLModule(self.module_spec)
        self.learner = make_learner(self.module)
        self.runners = EnvRunnerGroup(config, self.module_spec)
        self._return_window: list[float] = []

    def train(self) -> dict:
        raise NotImplementedError

    def stop(self):
        try:
            self.runners.stop()
        except AttributeError:
            pass


class PPO(Algorithm):
    def __init__(self, config: PPOConfig):
        super().__init__(config)
        self._bootstrap(lambda module: PPOLearner(
            module, config.learner, seed=config.seed, device=self.device))

    def train(self) -> dict:
        """One iteration: parallel sample -> GAE -> minibatched PPO epochs
        -> weight broadcast. Returns reference-shaped metrics."""
        cfg = self.config
        self.runners.sync_weights(self.learner.get_weights())
        batches = self.runners.sample(cfg.rollout_fragment_length)

        # Stack runner batches along the env axis: [T, N_total, ...]
        cat = {k: np.concatenate([b[k] for b in batches], axis=1)
               for k in ("obs", "actions", "logp_old", "values", "rewards",
                         "dones")}
        last_values = np.concatenate([b["last_values"] for b in batches])
        lc = self.learner.cfg
        adv, targets = compute_gae(cat["rewards"], cat["values"],
                                   cat["dones"], last_values,
                                   lc.gamma, lc.gae_lambda)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        T, N = cat["obs"].shape[:2]
        flat = {
            "obs": cat["obs"].reshape(T * N, -1),
            "actions": cat["actions"].reshape(T * N).astype(np.int32),
            "logp_old": cat["logp_old"].reshape(T * N),
            "advantages": adv.reshape(T * N).astype(np.float32),
            "value_targets": targets.reshape(T * N).astype(np.float32),
        }
        stats = self.learner.update(flat)

        for b in batches:
            self._return_window.extend(b["episode_returns"])
        self._return_window = self._return_window[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": T * N,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
            **{f"learner/{k}": v for k, v in stats.items()},
        }


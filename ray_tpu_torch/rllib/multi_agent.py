"""Multi-agent: env runner with per-policy module mapping + MA-PPO.

Parity target: reference rllib/env/multi_agent_env_runner.py (one runner
steps an env hosting MANY agents; a policy_mapping_fn routes each agent id
to a module id; sample() returns per-MODULE batches) +
examples/multi_agent's MultiAgentCartPole, and the MultiAgentRLModule /
per-module Learner update of the new API stack.

Counterpart: ray_tpu/rllib/multi_agent.py. `MultiAgentEnvRunner` is
ported (a net per policy on `device`, numpy weights loaded into them, one
`torch.Generator` for every draw); `MultiAgentCartPole` and
`MultiAgentPPO` are copied (each policy's `PPOLearner` on
`config.device`, the runners on the CPU).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import CartPoleVecEnv
from ray_tpu_torch.rllib.env_runner import one_thread_on_cpu
from ray_tpu_torch.rllib.learner import (PPOLearner, PPOLearnerConfig,
                                         compute_gae)
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec, set_weights


class MultiAgentCartPole:
    """N vectorized copies of an M-agent CartPole: every agent balances its
    own pole each step (reference examples MultiAgentCartPole — independent
    dynamics, shared episode clock). obs()/step() speak dicts keyed by
    agent id, [N, ...] per agent."""

    def __init__(self, num_envs: int, num_agents: int = 2, seed: int = 0):
        self.num_envs = num_envs
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {aid: CartPoleVecEnv(num_envs, seed=seed + 97 * i)
                      for i, aid in enumerate(self.agent_ids)}

    @property
    def observation_dim(self) -> int:
        return 4

    @property
    def action_dim(self) -> int:
        return 2

    def obs(self) -> dict:
        return {aid: env.obs() for aid, env in self._envs.items()}

    def step(self, actions: dict):
        """actions: {agent_id: [N]} -> (obs, rewards, dones) dicts."""
        out_o, out_r, out_d = {}, {}, {}
        for aid, env in self._envs.items():
            o, r, d = env.step(actions[aid])
            out_o[aid], out_r[aid], out_d[aid] = o, r, d
        return out_o, out_r, out_d


class MultiAgentEnvRunner:
    """Rollout actor for multi-agent envs: holds one RLModule per POLICY
    (module id), maps agents to policies via policy_mapping_fn, and
    returns per-policy [T, N, ...] batches (reference
    multi_agent_env_runner.py sample())."""

    def __init__(self, env_ctor, num_envs: int, spec: RLModuleSpec,
                 module_ids: list, policy_mapping: dict, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        one_thread_on_cpu(self.device)
        self.env = env_ctor(num_envs, seed=seed)
        self.module_ids = list(module_ids)
        self.policy_mapping = dict(policy_mapping)  # agent_id -> module_id
        self.module = RLModule(spec)
        self.nets = {mid: self.module.init(seed, self.device)
                     for mid in self.module_ids}
        self._has_weights = False
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = self.env.obs()
        self._ep_ret = {aid: np.zeros(num_envs) for aid in self.env.agent_ids}
        self._done_returns: dict[str, list] = {aid: [] for aid in self.env.agent_ids}

    def set_weights(self, weights: dict):
        """weights: {module_id: numpy weights} for every module."""
        for mid, net in self.nets.items():
            set_weights(net, weights[mid])
        self._has_weights = True
        return True

    @torch.no_grad()
    def sample(self, num_steps: int) -> dict:
        """-> {module_id: batch} with per-module trajectories + metrics."""
        if not self._has_weights:
            raise RuntimeError("set_weights first")
        T, N = num_steps, self.env.num_envs
        agents = self.env.agent_ids
        buf = {aid: {"obs": np.zeros((T, N, self.env.observation_dim), np.float32),
                     "actions": np.zeros((T, N), np.int32),
                     "logp_old": np.zeros((T, N), np.float32),
                     "values": np.zeros((T, N), np.float32),
                     "rewards": np.zeros((T, N), np.float32),
                     "dones": np.zeros((T, N), np.float32)}
               for aid in agents}
        for t in range(T):
            actions = {}
            for aid in agents:
                mid = self.policy_mapping[aid]
                a, logp, v = self.module.forward_exploration(
                    self.nets[mid], self.obs[aid], self._gen)
                a = a.cpu().numpy()
                buf[aid]["obs"][t] = self.obs[aid]
                buf[aid]["actions"][t] = a
                buf[aid]["logp_old"][t] = logp.cpu().numpy()
                buf[aid]["values"][t] = v.cpu().numpy()
                actions[aid] = a
            self.obs, rewards, dones = self.env.step(actions)
            for aid in agents:
                buf[aid]["rewards"][t] = rewards[aid]
                buf[aid]["dones"][t] = dones[aid]
                self._ep_ret[aid] += rewards[aid]
                fin = dones[aid].astype(bool)
                if fin.any():
                    self._done_returns[aid].extend(
                        self._ep_ret[aid][fin].tolist())
                    self._ep_ret[aid][fin] = 0.0
        # Group agent trajectories by MODULE (multiple agents can share a
        # policy: their batches concatenate along the env axis).
        out: dict[str, dict] = {}
        for aid in agents:
            mid = self.policy_mapping[aid]
            _, last_v = self.module.forward_train(self.nets[mid],
                                                  self.obs[aid])
            b = dict(buf[aid])
            b["last_values"] = last_v.cpu().numpy()
            b["episode_returns"] = self._done_returns[aid]
            if mid not in out:
                out[mid] = b
            else:
                prev = out[mid]
                for k in ("obs", "actions", "logp_old", "values", "rewards",
                          "dones"):
                    prev[k] = np.concatenate([prev[k], b[k]], axis=1)
                prev["last_values"] = np.concatenate(
                    [prev["last_values"], b["last_values"]])
                prev["episode_returns"] = (prev["episode_returns"]
                                           + b["episode_returns"])
        self._done_returns = {aid: [] for aid in agents}
        return out


@dataclass
class MultiAgentPPOConfig(AlgorithmConfig):
    num_agents: int = 2
    learner: PPOLearnerConfig = field(default_factory=PPOLearnerConfig)
    #: agent_id -> module_id; default: every agent gets its OWN policy
    policy_mapping: Optional[dict] = None

    def multi_agent(self, *, num_agents: Optional[int] = None,
                    policy_mapping: Optional[dict] = None
                    ) -> "MultiAgentPPOConfig":
        if num_agents is not None:
            self.num_agents = num_agents
        if policy_mapping is not None:
            self.policy_mapping = policy_mapping
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(copy.deepcopy(self))


class MultiAgentPPO(Algorithm):
    """Independent PPO per policy module over a multi-agent env (the
    reference's default multi-agent training: one Learner update per
    module from its own agents' batches)."""

    def __init__(self, config: MultiAgentPPOConfig):
        super().__init__(config)
        agent_ids = [f"agent_{i}" for i in range(config.num_agents)]
        self.policy_mapping = config.policy_mapping or {
            aid: f"policy_{i}" for i, aid in enumerate(agent_ids)}
        self.module_ids = sorted(set(self.policy_mapping.values()))
        env_ctor = (config.env if callable(config.env) else
                    (lambda n, seed=0, _na=config.num_agents:
                     MultiAgentCartPole(n, _na, seed)))
        probe = env_ctor(1, seed=0)
        self.module_spec = RLModuleSpec(
            observation_dim=probe.observation_dim,
            action_dim=probe.action_dim,
            hidden=tuple(config.module_hidden))
        self.learners = {
            mid: PPOLearner(RLModule(self.module_spec), config.learner,
                            seed=config.seed + 31 * i, device=self.device)
            for i, mid in enumerate(self.module_ids)}
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(env_ctor, config.num_envs_per_env_runner,
                              self.module_spec, self.module_ids,
                              self.policy_mapping,
                              seed=config.seed + 1000 * i, device="cpu")
            for i in range(config.num_env_runners)]
        self._return_window: list[float] = []

    def train(self) -> dict:
        cfg = self.config
        weights = {mid: l.get_weights() for mid, l in self.learners.items()}
        ray_tpu_torch.get(
            [r.set_weights.remote(weights) for r in self.runners],
            timeout=120)
        per_runner = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length)
             for r in self.runners], timeout=300)
        steps = 0
        stats: dict = {}
        for mid in self.module_ids:
            batches = [pr[mid] for pr in per_runner if mid in pr]
            if not batches:
                continue
            cat = {k: np.concatenate([b[k] for b in batches], axis=1)
                   for k in ("obs", "actions", "logp_old", "values",
                             "rewards", "dones")}
            last_values = np.concatenate([b["last_values"] for b in batches])
            lc = self.learners[mid].cfg
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
            st = self.learners[mid].update(flat)
            stats[mid] = st
            steps += T * N
            for b in batches:
                self._return_window.extend(b["episode_returns"])
        self._return_window = self._return_window[-200:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": steps,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
            **{f"learner/{mid}/loss": s.get("loss", float("nan"))
               for mid, s in stats.items()},
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

"""DQN: off-policy Q-learning with double-Q targets + prioritized replay.

Parity target: reference rllib/algorithms/dqn/dqn.py (new API stack:
EnvRunners collect with epsilon-greedy, transitions land in a prioritized
replay buffer, the learner samples minibatches, double-DQN targets, target
net synced every `target_network_update_freq` steps, TD errors fed back as
priorities).

Counterpart: ray_tpu/rllib/dqn.py. `QNet`, `DQNLearner` and
`DQNEnvRunner` are ported; `DQNConfig` and `DQN` are copied (the learner
on `config.device`, the runners on the CPU). The JAX package's target
params alias the online params, which is safe for immutable arrays; here
the optimizer steps the online net in place, so the target net is a copy,
taken at construction and at every `target_update_freq`-th update, and
nothing else writes it. `get_weights` returns host numpy arrays.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import one_thread_on_cpu
from ray_tpu_torch.rllib.learner import adam, batch_to
from ray_tpu_torch.rllib.replay import ReplayBufferGroup
from ray_tpu_torch.rllib.rl_module import (MLPNet, RLModuleSpec, get_weights,
                                          set_weights)


class QNet(MLPNet):
    """relu MLP with a Q head `q` [action_dim]."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0, device="cuda"):
        super().__init__(spec, {"q": spec.action_dim}, seed,
                         resolve_device(device))

    def forward(self, obs):
        return self.q(self.trunk(obs, F.relu))


@dataclass
class DQNLearnerConfig:
    lr: float = 1e-3
    gamma: float = 0.99
    target_update_freq: int = 100  # learner updates between target syncs
    huber_delta: float = 1.0


class DQNLearner:
    """Double-DQN learner (reference dqn_rainbow_torch_learner
    compute_loss_for_module)."""

    def __init__(self, spec: RLModuleSpec, cfg: DQNLearnerConfig, seed=0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.net = QNet(spec, seed=seed, device=self.device)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.opt = adam(self.net.parameters(), cfg.lr)
        self._updates = 0

    def _loss(self, batch, weights):
        cfg = self.cfg
        q = self.net(batch["obs"])  # [B, A]
        q_sa = q.gather(-1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            # Double DQN: online net picks a', target net evaluates it.
            next_a = torch.argmax(self.net(batch["next_obs"]), dim=-1)
            next_v = self.target_net(batch["next_obs"]).gather(
                -1, next_a[:, None])[:, 0]
            target = batch["rewards"] + cfg.gamma * (
                1.0 - batch["dones"]) * next_v
        td = q_sa - target
        loss = (weights * F.huber_loss(td, torch.zeros_like(td),
                                       reduction="none",
                                       delta=cfg.huber_delta)).mean()
        return loss, td

    def update(self, batch: dict, weights: np.ndarray):
        """-> (stats, |td| per sample for priority feedback)."""
        tb = batch_to({k: batch[k] for k in ("obs", "actions", "rewards",
                                              "next_obs", "dones")},
                      self.device)
        w = torch.as_tensor(np.asarray(weights, np.float32),
                            device=self.device)
        with torch.enable_grad():
            loss, td = self._loss(tb, w)
            self.opt.zero_grad()
            loss.backward()
        self.opt.step()
        self._updates += 1
        if self._updates % self.cfg.target_update_freq == 0:
            self.target_net.load_state_dict(self.net.state_dict())
        return ({"loss": loss.item(), "num_updates": self._updates},
                td.detach().abs().cpu().numpy())

    def get_weights(self) -> dict[str, np.ndarray]:
        return get_weights(self.net)


class DQNEnvRunner:
    """Epsilon-greedy rollout actor emitting TRANSITIONS (off-policy: the
    batch is (s, a, r, s', done) tuples, not trajectories). Reference
    single_agent_env_runner with the epsilon-greedy exploration connector."""

    def __init__(self, env_name, num_envs: int, spec: RLModuleSpec, seed=0,
                 device="cuda"):
        self.device = resolve_device(device)
        one_thread_on_cpu(self.device)
        self.env = make_vec_env(env_name, num_envs, seed=seed)
        self.net = QNet(spec, seed=seed, device=self.device)
        self._has_weights = False
        self._rng = np.random.RandomState(seed)
        self.obs = self.env.obs()
        self._ep_ret = np.zeros(num_envs, np.float64)
        self._done_returns: list[float] = []

    def set_weights(self, weights):
        set_weights(self.net, weights)
        self._has_weights = True
        return True

    @torch.no_grad()
    def sample(self, num_steps: int, epsilon: float) -> dict:
        if not self._has_weights:
            raise RuntimeError("set_weights first")
        N = self.env.num_envs
        obs_b, act_b, rew_b, next_b, done_b = [], [], [], [], []
        for _ in range(num_steps):
            q = self.net(torch.as_tensor(self.obs, device=self.device))
            q = q.cpu().numpy()
            greedy = q.argmax(axis=-1)
            rand = self._rng.randint(0, q.shape[-1], size=N)
            explore = self._rng.random_sample(N) < epsilon
            action = np.where(explore, rand, greedy).astype(np.int64)
            obs_b.append(self.obs.copy())
            self.obs, rewards, dones = self.env.step(action)
            act_b.append(action)
            rew_b.append(rewards)
            next_b.append(self.obs.copy())
            done_b.append(dones)
            self._ep_ret += rewards
            fin = dones.astype(bool)
            if fin.any():
                self._done_returns.extend(self._ep_ret[fin].tolist())
                self._ep_ret[fin] = 0.0
        returns, self._done_returns = self._done_returns, []
        return {
            "obs": np.concatenate(obs_b).astype(np.float32),
            "actions": np.concatenate(act_b).astype(np.int32),
            "rewards": np.concatenate(rew_b).astype(np.float32),
            "next_obs": np.concatenate(next_b).astype(np.float32),
            "dones": np.concatenate(done_b).astype(np.float32),
            "episode_returns": returns,
        }


@dataclass
class DQNConfig(AlgorithmConfig):
    learner: DQNLearnerConfig = field(default_factory=DQNLearnerConfig)
    replay_capacity: int = 50_000
    replay_shards: int = 1
    replay_alpha: float = 0.6
    replay_beta: float = 0.4
    train_batch_size: int = 64
    num_learner_updates: int = 16  # sgd steps per train() iteration
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 20
    learning_starts: int = 500  # min transitions before updates begin

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 target_update_freq: Optional[int] = None,
                 train_batch_size: Optional[int] = None,
                 num_learner_updates: Optional[int] = None) -> "DQNConfig":
        kw = {k: v for k, v in dict(
            lr=lr, gamma=gamma,
            target_update_freq=target_update_freq).items() if v is not None}
        self.learner = replace(self.learner, **kw)
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if num_learner_updates is not None:
            self.num_learner_updates = num_learner_updates
        return self

    def build(self) -> "DQN":
        return DQN(copy.deepcopy(self))


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        super().__init__(config)
        probe = make_vec_env(config.env, 1, seed=0)
        self.module_spec = RLModuleSpec(
            observation_dim=probe.observation_dim,
            action_dim=probe.action_dim,
            hidden=tuple(config.module_hidden))
        self.learner = DQNLearner(self.module_spec, config.learner,
                                  seed=config.seed, device=self.device)
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(DQNEnvRunner)
        self.runners = [
            runner_cls.remote(config.env, config.num_envs_per_env_runner,
                              self.module_spec, seed=config.seed + 1000 * i,
                              device="cpu")
            for i in range(config.num_env_runners)]
        self.buffer = ReplayBufferGroup(
            num_shards=config.replay_shards,
            capacity=config.replay_capacity, alpha=config.replay_alpha)
        self._return_window: list[float] = []
        self._transitions = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def train(self) -> dict:
        cfg = self.config
        eps = self._epsilon()
        weights = self.learner.get_weights()
        ray_tpu_torch.get(
            [r.set_weights.remote(weights) for r in self.runners],
            timeout=120)
        batches = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length, eps)
             for r in self.runners], timeout=300)
        add_refs = []
        for b in batches:
            self._return_window.extend(b.pop("episode_returns"))
            self._transitions += len(b["obs"])
            add_refs.append(self.buffer.add_batch(b))
        ray_tpu_torch.get(add_refs, timeout=120)
        self._return_window = self._return_window[-100:]
        stats: dict = {}
        if self._transitions >= cfg.learning_starts:
            for _ in range(cfg.num_learner_updates):
                batch, index_map, w = self.buffer.sample(
                    cfg.train_batch_size, cfg.replay_beta)
                if not batch:
                    break
                stats, td = self.learner.update(batch, w)
                # TD errors feed back as new priorities (the prioritized
                # part of prioritized replay).
                self.buffer.update_priorities(index_map, td)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": sum(len(b["obs"]) for b in batches),
            "num_transitions": self._transitions,
            "epsilon": eps,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.buffer.stop()

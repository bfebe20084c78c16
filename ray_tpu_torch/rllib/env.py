"""Vectorized environments (numpy, no gym dependency).

Parity target: reference rllib/env/ (EnvRunner-facing vector env API;
gymnasium's CartPole-v1 physics reproduced exactly — BASELINE.md names PPO
CartPole as a north-star workload). Vectorized in numpy so a whole batch of
envs steps in one call: host-side rollouts stay cheap while the learner
owns the accelerator.

Counterpart: ray_tpu/rllib/env.py (copied).
"""

from __future__ import annotations

import numpy as np


class CartPoleVecEnv:
    """N independent CartPole-v1 instances (classic Barto-Sutton physics).

    obs: [N, 4] float32; actions: {0, 1}; reward 1.0 per live step;
    terminates at |x|>2.4, |theta|>12deg, or 500 steps (truncation)."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.rng = np.random.RandomState(seed)
        self.state = np.zeros((num_envs, 4), dtype=np.float64)
        self.steps = np.zeros(num_envs, dtype=np.int64)
        self.reset()

    @property
    def observation_dim(self) -> int:
        return 4

    @property
    def action_dim(self) -> int:
        return 2

    def reset(self) -> np.ndarray:
        self.state = self.rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self.steps[:] = 0
        return self.obs()

    def _reset_where(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self.state[mask] = self.rng.uniform(-0.05, 0.05, (n, 4))
            self.steps[mask] = 0

    def obs(self) -> np.ndarray:
        return self.state.astype(np.float32)

    def step(self, actions: np.ndarray):
        """Returns (obs, rewards, dones). Done envs auto-reset; the returned
        obs is the post-reset observation (standard vec-env contract)."""
        x, x_dot, th, th_dot = self.state.T
        force = np.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costh, sinth = np.cos(th), np.sin(th)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        temp = (force + polemass_length * th_dot**2 * sinth) / total_mass
        th_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costh**2 / total_mass))
        x_acc = temp - polemass_length * th_acc * costh / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        th = th + self.TAU * th_dot
        th_dot = th_dot + self.TAU * th_acc
        self.state = np.stack([x, x_dot, th, th_dot], axis=1)
        self.steps += 1

        terminated = (np.abs(x) > self.X_LIMIT) | (np.abs(th) > self.THETA_LIMIT)
        truncated = self.steps >= self.MAX_STEPS
        dones = terminated | truncated
        rewards = np.ones(self.num_envs, dtype=np.float32)
        self._reset_where(dones)
        return self.obs(), rewards, dones.astype(np.float32)


ENV_REGISTRY = {
    "CartPole-v1": CartPoleVecEnv,
}


def make_vec_env(name: str, num_envs: int, seed: int = 0):
    if callable(name):
        return name(num_envs, seed)
    cls = ENV_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown env {name!r}; register it in "
                         f"ray_tpu_torch.rllib.env.ENV_REGISTRY")
    return cls(num_envs, seed=seed)

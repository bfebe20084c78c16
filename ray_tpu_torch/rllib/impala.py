"""IMPALA: async actor-learner with V-trace off-policy correction.

Parity target: reference rllib/algorithms/impala/impala.py:599 (async
sampling — the learner consumes whichever runner finishes first, never
barriering on the slowest — with V-trace importance-sampling correction
for the policy lag, per the IMPALA paper's rho/c-clipped targets).

Counterpart: ray_tpu/rllib/impala.py. `IMPALALearner` is ported: the
JAX package's backwards `lax.scan` over the rollout becomes a reversed
loop over T under `torch.no_grad()` (the JAX package stops the gradient
at V-trace's outputs), and the optimizer is the PPO learner's optax
chain (`clip_by_global_norm_`, then Adam). `IMPALA`'s async harvest loop
is copied: `ray_tpu_torch.wait` over in-flight sample futures,
re-syncing weights (host numpy) only to the runner being relaunched.
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
from ray_tpu_torch.rllib.learner import (adam, batch_to, clip_by_global_norm_,
                                         entropy_of)
from ray_tpu_torch.rllib.rl_module import RLModule, get_weights


@dataclass(frozen=True)
class IMPALALearnerConfig:
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    max_grad_norm: float = 40.0
    rho_clip: float = 1.0  # V-trace rho-bar (value-target IS clip)
    c_clip: float = 1.0    # V-trace c-bar (trace-cutting IS clip)


@dataclass
class IMPALAConfig(AlgorithmConfig):
    learner: IMPALALearnerConfig = field(default_factory=IMPALALearnerConfig)
    #: batches consumed per train() call (one async harvest each)
    updates_per_iteration: int = 4

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 vf_coeff: Optional[float] = None,
                 rho_clip: Optional[float] = None,
                 c_clip: Optional[float] = None,
                 updates_per_iteration: Optional[int] = None) -> "IMPALAConfig":
        kw = {k: v for k, v in dict(
            lr=lr, gamma=gamma, entropy_coeff=entropy_coeff,
            vf_coeff=vf_coeff, rho_clip=rho_clip, c_clip=c_clip).items()
            if v is not None}
        self.learner = replace(self.learner, **kw)
        if updates_per_iteration is not None:
            self.updates_per_iteration = updates_per_iteration
        return self

    def build(self) -> "IMPALA":
        return IMPALA(copy.deepcopy(self))


class IMPALALearner:
    """V-trace learner (reference impala_learner.py + vtrace_torch.py,
    recomputed here from the published recursion)."""

    def __init__(self, module: RLModule, config: IMPALALearnerConfig,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.module = module
        self.cfg = config
        self.net = module.init(seed, self.device)
        self.params = list(self.net.parameters())
        # Adam rather than the reference's Atari-tuned RMSProp(eps=0.1):
        # that epsilon over-damps small-MLP control tasks by ~100x.
        self.opt = adam(self.params, config.lr)

    @torch.no_grad()
    def _vtrace(self, values, last_value, rewards, dones, rhos):
        """vs_t = V_t + delta_t + gamma c_t (vs_{t+1} - V_{t+1}); backwards
        over T. Returns (vs [T,N], pg_advantages [T,N]), no gradient."""
        cfg = self.cfg
        rho = torch.clamp(rhos, max=cfg.rho_clip)
        c = torch.clamp(rhos, max=cfg.c_clip)
        nonterm = 1.0 - dones
        next_values = torch.cat([values[1:], last_value[None]], dim=0)
        deltas = rho * (rewards + cfg.gamma * next_values * nonterm - values)
        acc = torch.zeros_like(values)  # acc[t] = vs_t - V_t
        run = torch.zeros_like(values[0])
        for t in reversed(range(values.shape[0])):
            run = deltas[t] + cfg.gamma * c[t] * nonterm[t] * run
            acc[t] = run
        vs = values + acc
        next_vs = torch.cat([vs[1:], last_value[None]], dim=0)
        pg_adv = rho * (rewards + cfg.gamma * next_vs * nonterm - values)
        return vs, pg_adv

    def _loss(self, batch):
        cfg = self.cfg
        T, N = batch["obs"].shape[:2]
        flat_obs = batch["obs"].reshape(T * N, -1)
        logits, values = self.module.forward_train(self.net, flat_obs)
        logits = logits.reshape(T, N, -1)
        values = values.reshape(T, N)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
        rhos = torch.exp(logp - batch["logp_old"])
        _, last_value = self.module.forward_train(self.net, batch["last_obs"])
        vs, pg_adv = self._vtrace(values, last_value, batch["rewards"],
                                  batch["dones"], rhos)
        pi_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = entropy_of(logp_all)
        loss = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return loss, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": entropy}

    def _update(self, batch: dict) -> dict:
        """One step on `batch` (tensors on the device)."""
        with torch.enable_grad():
            loss, aux = self._loss(batch)
            self.opt.zero_grad()
            loss.backward()
        clip_by_global_norm_(self.params, self.cfg.max_grad_norm)
        self.opt.step()
        stats = torch.stack([loss.detach()] +
                            [v.detach() for v in aux.values()]).tolist()
        return dict(zip(["loss", "pi_loss", "vf_loss", "entropy"], stats))

    def update(self, batch: dict) -> dict:
        return self._update(batch_to(
            {k: batch[k] for k in ("obs", "actions", "logp_old", "rewards",
                                   "dones", "last_obs")}, self.device))

    def get_weights(self) -> dict[str, np.ndarray]:
        return get_weights(self.net)


class IMPALA(Algorithm):
    """Async harvest loop: every runner always has a sample() in flight;
    train() consumes the first `updates_per_iteration` arrivals, updating
    the learner on each and relaunching THAT runner with fresh weights."""

    def __init__(self, config: IMPALAConfig):
        super().__init__(config)
        self._bootstrap(lambda module: IMPALALearner(
            module, config.learner, seed=config.seed, device=self.device))
        self._inflight: dict = {}  # ref -> runner
        w = self.learner.get_weights()
        for r in self.runners.runners:
            ray_tpu_torch.get(r.set_weights.remote(w), timeout=120)
            self._inflight[r.sample.remote(config.rollout_fragment_length)] = r

    def train(self) -> dict:
        cfg = self.config
        steps = 0
        stats: dict = {}
        for _ in range(cfg.updates_per_iteration):
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                          timeout=300)
            if not ready:
                raise RuntimeError(
                    "IMPALA: no env-runner produced a sample within 300s "
                    f"({len(self._inflight)} in flight) — runner dead or "
                    "sampling stalled")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref, timeout=60)
            stats = self.learner.update(batch)
            self._return_window.extend(batch["episode_returns"])
            steps += batch["obs"].shape[0] * batch["obs"].shape[1]
            # Relaunch ONLY this runner, with post-update weights (the
            # policy lag this creates is exactly what V-trace corrects).
            runner.set_weights.remote(self.learner.get_weights())
            self._inflight[runner.sample.remote(
                cfg.rollout_fragment_length)] = runner
        self._return_window = self._return_window[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": steps,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
            **{f"learner/{k}": v for k, v in stats.items()},
        }

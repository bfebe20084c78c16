"""PPO Learner: the update step.

Parity target: reference rllib/core/learner/learner.py:107 +
algorithms/ppo/ppo_learner.py (clipped surrogate + value loss + entropy
bonus, minibatched epochs).

Counterpart: ray_tpu/rllib/learner.py. The JAX package runs the whole
update (every epoch and minibatch) as one `lax.scan` over permutations
drawn by `jax.random.permutation`; here `_update` loops over epochs and
minibatches on the learner's device and takes the epochs' permutations
as an argument (`update` draws them from the learner's own generator), so
a test can feed it JAX's. The optimizer is optax's chain
`clip_by_global_norm(max_grad_norm)` then `adam(lr)`: `clip_by_global_norm_`
below, then `torch.optim.Adam` with optax's defaults. Loss statistics stay
on the device until the update ends. `compute_gae` is copied as it is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.rl_module import RLModule, get_weights


@dataclass(frozen=True)
class PPOLearnerConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    max_grad_norm: float = 0.5


def adam(params, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """`optax.clip_by_global_norm` on the .grad of `params`, in place:
    every gradient becomes g / norm * max_norm when the global norm is at
    least max_norm and stays as it is below (torch's `clip_grad_norm_`
    divides by norm + 1e-6 instead). Returns the norm; no host sync."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def batch_to(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device` (ints as int64 for gathers)."""
    out = {}
    for k, v in batch.items():
        t = torch.tensor(np.asarray(v))
        out[k] = t.to(device, torch.int64 if not t.is_floating_point()
                      else torch.float32)
    return out


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    return -(logp_all.exp() * logp_all).sum(-1).mean()


class PPOLearner:
    def __init__(self, module: RLModule, config: PPOLearnerConfig,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.module = module
        self.cfg = config
        self.net = module.init(seed, self.device)
        self.params = list(self.net.parameters())
        self.opt = adam(self.params, config.lr)
        self._gen = torch.Generator().manual_seed(seed + 1)

    # ------------------------------------------------------------- update
    def _loss(self, batch):
        cfg = self.cfg
        logits, values = self.module.forward_train(self.net, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv)
        pi_loss = -surr.mean()
        vf_loss = ((values - batch["value_targets"]) ** 2).mean()
        entropy = entropy_of(logp_all)
        loss = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return loss, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": entropy}

    def _update(self, batch: dict, perms) -> dict:
        """All epochs over `batch` (tensors on the device), epoch e taking
        its minibatches from the permutation perms[e] of range(n)."""
        cfg = self.cfg
        n = batch["obs"].shape[0]
        # A batch smaller than minibatch_size trains as one (smaller)
        # minibatch instead of crashing the reshape.
        mb_size = min(cfg.minibatch_size, n)
        n_mb = max(1, n // mb_size)
        usable = n_mb * mb_size
        rows = []
        with torch.enable_grad():
            for perm in perms:
                idx = torch.as_tensor(perm, dtype=torch.int64)[:usable]
                for mb_idx in idx.to(self.device).reshape(n_mb, mb_size):
                    mb = {k: v[mb_idx] for k, v in batch.items()}
                    loss, aux = self._loss(mb)
                    self.opt.zero_grad()
                    loss.backward()
                    clip_by_global_norm_(self.params, cfg.max_grad_norm)
                    self.opt.step()
                    rows.append(torch.stack(
                        [loss.detach()] + [v.detach() for v in aux.values()]))
        # Every epoch has n_mb minibatches, so the mean of the epochs'
        # means is the mean over all minibatches.
        means = torch.stack(rows).mean(0).tolist()
        return dict(zip(["loss", "pi_loss", "vf_loss", "entropy"], means))

    def update(self, batch: dict) -> dict:
        """batch: numpy dict with obs/actions/logp_old/advantages/
        value_targets. Returns training stats."""
        tb = batch_to(batch, self.device)
        n = tb["obs"].shape[0]
        perms = [torch.randperm(n, generator=self._gen)
                 for _ in range(self.cfg.num_epochs)]
        return self._update(tb, perms)

    def get_weights(self) -> dict[str, np.ndarray]:
        return get_weights(self.net)


def compute_gae(rewards, values, dones, last_values, gamma, lam):
    """GAE over [T, N] rollouts (reference postprocessing
    compute_advantages). Pure numpy: runs where the rollout lives."""
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last_gae = np.zeros_like(rewards[0])
    next_values = last_values
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_values * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_values = values[t]
    value_targets = adv + values
    return adv, value_targets

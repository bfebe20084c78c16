"""RLModule: the policy/value network abstraction.

Parity target: reference rllib/core/rl_module/rl_module.py:260 (the new-API
RLModule with forward_inference / forward_exploration / forward_train).

Counterpart: ray_tpu/rllib/rl_module.py. The JAX package's forwards are
pure functions of a flax param tree; here they take the `nn.Module` that
holds the parameters (`RLModule.init` builds it on an explicit device), so
a learner steps its parameters in place with `torch.optim` and an env
runner loads numpy weights into its own copy. Layers are `nn.Linear`
(weight [out, in], where flax's kernel is [in, out]: `params_from_flax`
transposes), initialised as flax initialises `nn.Dense`: weights
lecun-normal (a normal truncated at +-2 sigma, sigma = 1/sqrt(fan_in) /
0.8796), biases zero, drawn from a `torch.Generator` seeded from `seed`
on the CPU, so every device starts from the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device

#: standard deviation of a unit normal truncated to [-2, 2]; flax divides
#: by it so that the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class RLModuleSpec:
    """reference rl_module.RLModuleSpec: how to build the module."""

    observation_dim: int
    action_dim: int
    hidden: tuple = (64, 64)


def _lecun_normal(fan_out: int, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """[fan_out, fan_in] weight, flax's `lecun_normal` for a Dense of
    fan_in inputs: unit normals redrawn until inside [-2, 2], scaled."""
    x = torch.randn(fan_out, fan_in, generator=gen)
    while True:
        bad = x.abs() > 2.0
        n = int(bad.sum())
        if not n:
            break
        x[bad] = torch.randn(n, generator=gen)
    return x * (fan_in ** -0.5 / _TRUNC_STD)


class MLPNet(nn.Module):
    """Dense layers `fc{i}` over `spec.hidden`, then the named heads; every
    weight lecun-normal from `seed`, every bias zero."""

    def __init__(self, spec: RLModuleSpec, heads: dict, seed: int,
                 device: torch.device):
        super().__init__()
        widths = (spec.observation_dim,) + tuple(spec.hidden)
        layers = [(f"fc{i}", a, b) for i, (a, b) in
                  enumerate(zip(widths, widths[1:]))]
        layers += [(name, widths[-1], n) for name, n in heads.items()]
        gen = torch.Generator().manual_seed(seed)
        for name, fan_in, fan_out in layers:
            # built on "meta" so that nothing draws from the global RNG
            lin = nn.Linear(fan_in, fan_out, device="meta").to_empty(
                device=device)
            with torch.no_grad():
                lin.weight.copy_(_lecun_normal(fan_out, fan_in, gen))
                lin.bias.zero_()
            self.add_module(name, lin)
        self.n_hidden = len(spec.hidden)

    def trunk(self, obs, act):
        x = obs
        for i in range(self.n_hidden):
            x = act(getattr(self, f"fc{i}")(x))
        return x


class PolicyValueNet(MLPNet):
    """tanh MLP with a policy head `pi` [action_dim] and a value head `vf`."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0, device="cuda"):
        super().__init__(spec, {"pi": spec.action_dim, "vf": 1}, seed,
                         resolve_device(device))

    def forward(self, obs):
        x = self.trunk(obs, torch.tanh)
        return self.pi(x), self.vf(x)[..., 0]


def get_weights(net: nn.Module) -> dict[str, np.ndarray]:
    """The net's parameters as host numpy arrays (what runners receive)."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in net.state_dict().items()}


def set_weights(net: nn.Module, weights: dict) -> None:
    """Copy numpy arrays (or tensors) into the net's parameters in place."""
    net.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in weights.items()})


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Flax Dense param tree (numpy leaves; with or without the outer
    "params" key) -> state_dict: `{name}/kernel` [in, out] becomes
    `{name}.weight` [out, in], `{name}/bias` stays `{name}.bias`."""
    tree = tree.get("params", tree)
    out = {}
    for name, leaves in tree.items():
        out[f"{name}.weight"] = torch.from_numpy(
            np.array(leaves["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(
            np.array(leaves["bias"], np.float32))
    return out


class RLModule:
    """The reference's forward_* surface over a `PolicyValueNet`."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    def init(self, seed: int = 0, device="cuda") -> PolicyValueNet:
        return PolicyValueNet(self.spec, seed=seed, device=device)

    @staticmethod
    def _obs(net, obs) -> torch.Tensor:
        return torch.as_tensor(obs, dtype=torch.float32,
                               device=net.pi.weight.device)

    def forward_train(self, net: PolicyValueNet, obs):
        """-> (logits, values); used inside the PPO loss."""
        return net(self._obs(net, obs))

    @torch.no_grad()
    def forward_exploration(self, net: PolicyValueNet, obs,
                            gen: torch.Generator):
        """Sample actions + logp + value (env-runner rollout step): an
        action per row drawn from softmax(logits) by Gumbel-max with `gen`
        (a generator on the net's device)."""
        logits, value = net(self._obs(net, obs))
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        logp = F.log_softmax(logits, dim=-1).gather(
            -1, action[:, None])[:, 0]
        return action, logp, value

    @torch.no_grad()
    def forward_inference(self, net: PolicyValueNet, obs):
        """Greedy actions (serving/eval)."""
        logits, _ = net(self._obs(net, obs))
        return torch.argmax(logits, dim=-1)

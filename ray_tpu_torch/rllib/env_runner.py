"""EnvRunner: the rollout actor.

Parity target: reference rllib/env/single_agent_env_runner.py:68 +
env_runner_group.py:71 — a fleet of actors each stepping a vectorized env
with the current policy, returning sample batches; weights broadcast each
iteration.

Counterpart: ray_tpu/rllib/env_runner.py. The runner holds its own
`PolicyValueNet` on `device` and loads the learner's numpy weights into
it; actions come from one `torch.Generator` per runner, seeded from
`seed` (the JAX package splits a PRNG key per step, so the draws agree in
distribution, not one by one). `EnvRunnerGroup` builds runners on the
CPU, as the JAX package's runner actors ask for a CPU and no chip.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec, set_weights


def one_thread_on_cpu(device: torch.device) -> None:
    """A CPU runner actor holds one CPU (num_cpus=1), and its forwards are
    [num_envs, 64] products: torch's intra-op pool, sized to every core,
    only makes the runners of a host spin against each other."""
    if device.type == "cpu":
        torch.set_num_threads(1)


class SingleAgentEnvRunner:
    """Wrapped with ray_tpu_torch.remote by EnvRunnerGroup (so per-runner
    resources can be attached)."""

    def __init__(self, env_name, num_envs: int, module_spec: RLModuleSpec,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        one_thread_on_cpu(self.device)
        self.env = make_vec_env(env_name, num_envs, seed=seed)
        self.module = RLModule(module_spec)
        self.net = self.module.init(seed, self.device)
        self._has_weights = False
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = self.env.obs()
        # episode-return bookkeeping (reference metrics: episode_return_mean)
        self._ep_ret = np.zeros(num_envs, dtype=np.float64)
        self._done_returns: list[float] = []

    def set_weights(self, weights):
        set_weights(self.net, weights)
        self._has_weights = True
        return True

    @torch.no_grad()
    def sample(self, num_steps: int) -> dict:
        """Roll out num_steps per env with the CURRENT weights. Returns a
        [T, N, ...] batch (numpy) + rollout metrics."""
        if not self._has_weights:
            raise RuntimeError("set_weights first")
        T, N = num_steps, self.env.num_envs
        obs_buf = np.zeros((T, N, self.env.observation_dim), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        for t in range(T):
            action, logp, value = self.module.forward_exploration(
                self.net, self.obs, self._gen)
            action = action.cpu().numpy()
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = logp.cpu().numpy()
            val_buf[t] = value.cpu().numpy()
            self.obs, rewards, dones = self.env.step(action)
            rew_buf[t] = rewards
            done_buf[t] = dones
            self._ep_ret += rewards
            finished = dones.astype(bool)
            if finished.any():
                self._done_returns.extend(self._ep_ret[finished].tolist())
                self._ep_ret[finished] = 0.0
        _, last_values = self.module.forward_train(self.net, self.obs)
        returns, self._done_returns = self._done_returns, []
        return {
            "obs": obs_buf, "actions": act_buf, "logp_old": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "last_values": last_values.cpu().numpy(),
            # Bootstrap observation for off-policy learners (IMPALA's
            # V-trace re-evaluates it under the CURRENT params).
            "last_obs": np.asarray(self.obs, dtype=np.float32),
            "episode_returns": returns,
        }

"""ray_tpu_torch.rllib — reinforcement learning on the cluster runtime.

Parity target: reference rllib/ new API stack (Algorithm / AlgorithmConfig,
RLModule, Learner, EnvRunner/EnvRunnerGroup). The policy is a torch
module; the learners (PPO, IMPALA, DQN and multi-agent PPO's per-policy
PPO) run on `AlgorithmConfig.device` (default "cuda"), and rollouts run on
parallel env-runner actors on the CPU with numpy vector envs.

Counterpart: ray_tpu/rllib/__init__.py (the same exports).
"""

from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    EnvRunnerGroup,
    PPO,
    PPOConfig,
)
from ray_tpu_torch.rllib.dqn import (DQN, DQNConfig, DQNEnvRunner, DQNLearner,
                                     DQNLearnerConfig)
from ray_tpu_torch.rllib.env import (ENV_REGISTRY, CartPoleVecEnv,
                                     make_vec_env)
from ray_tpu_torch.rllib.impala import (IMPALA, IMPALAConfig, IMPALALearner,
                                        IMPALALearnerConfig)
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import (PPOLearner, PPOLearnerConfig,
                                         compute_gae)
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentCartPole,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.replay import (PrioritizedReplayBuffer,
                                        ReplayBufferGroup)
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "CartPoleVecEnv",
    "DQN",
    "DQNConfig",
    "DQNEnvRunner",
    "DQNLearner",
    "DQNLearnerConfig",
    "ENV_REGISTRY",
    "EnvRunnerGroup",
    "IMPALA",
    "IMPALAConfig",
    "IMPALALearner",
    "IMPALALearnerConfig",
    "MultiAgentCartPole",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PPOLearnerConfig",
    "PrioritizedReplayBuffer",
    "ReplayBufferGroup",
    "RLModule",
    "RLModuleSpec",
    "SingleAgentEnvRunner",
    "compute_gae",
    "make_vec_env",
]

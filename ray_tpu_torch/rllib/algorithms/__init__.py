from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig

__all__ = [
    "BC", "BCConfig", "DQN", "DQNConfig", "IMPALA", "IMPALAConfig",
    "PPO", "PPOConfig", "SAC", "SACConfig",
]

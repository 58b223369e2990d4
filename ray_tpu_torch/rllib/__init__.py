"""RLlib-equivalent RL stack of the PyTorch port.

Counterpart of ray_tpu/rllib: rollouts on the host CPU (EnvRunner), SGD
on the card (TreeLearner and its subclasses, in-process through
LearnerGroup), algorithms as Trainables built by a fluent config: PPO
(single- and multi-agent) and IMPALA (algorithms/ppo.py, impala.py), the
off-policy DQN and SAC with replay buffers on the host
(algorithms/dqn.py, sac.py, replay_buffers.py), and the offline BC,
trained from JSON experience files (algorithms/bc.py, offline.py). See
algorithm.py for what of the reference's topology is ported.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms import (
    BC,
    BCConfig,
    DQN,
    DQNConfig,
    SAC,
    SACConfig,
)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.multi_agent_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.learner import (
    IMPALALearner,
    LearnerGroup,
    PPOLearner,
    TorchLearner,
    TreeLearner,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "BC",
    "BCConfig",
    "DQN",
    "DQNConfig",
    "SAC",
    "SACConfig",
    "EnvRunner",
    "MultiAgentEnvRunner",
    "IMPALALearner",
    "TorchLearner",
    "TreeLearner",
    "LearnerGroup",
    "PPOLearner",
    "SampleBatch",
]

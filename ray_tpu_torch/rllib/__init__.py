"""RLlib-equivalent RL stack of the PyTorch port.

Counterpart of ray_tpu/rllib: rollouts on the host CPU (EnvRunner), SGD
on the card (TorchLearner, in-process through LearnerGroup), algorithms
(PPO, IMPALA) as Trainables built by a fluent config. See algorithm.py
for what of the reference's topology is ported.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.multi_agent_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.learner import (
    IMPALALearner,
    LearnerGroup,
    PPOLearner,
    TorchLearner,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "EnvRunner",
    "MultiAgentEnvRunner",
    "IMPALALearner",
    "TorchLearner",
    "LearnerGroup",
    "PPOLearner",
    "SampleBatch",
]

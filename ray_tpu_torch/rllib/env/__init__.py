from ray_tpu_torch.rllib.env.cartpole import CartPoleVectorEnv
from ray_tpu_torch.rllib.env.pong import PongVectorEnv
from ray_tpu_torch.rllib.env.vector_env import VectorEnv, make_vector_env, register_env

__all__ = [
    "VectorEnv",
    "make_vector_env",
    "register_env",
    "CartPoleVectorEnv",
    "PongVectorEnv",
]

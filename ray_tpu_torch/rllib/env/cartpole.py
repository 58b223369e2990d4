"""The port's copy of ray_tpu/rllib/env/cartpole.py (numpy on the host,
the same dynamics and draws), registered as CartPole-v1.

Dependency-free vectorized CartPole-v1 (classic control dynamics).

The graded BASELINE config 2 is "PPO CartPole-v1, reward >= 150 within 100k
steps" (reference regression target rllib/tuned_examples/ppo/cartpole-ppo.yaml:4-6).
Shipping the env natively keeps the learning test hermetic — no gymnasium
dependency. Dynamics follow the standard cart-pole equations (Barto, Sutton &
Anderson 1983) with the Gym constants; all N lanes step as one numpy op.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env.vector_env import VectorEnv, register_env

GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
HALF_POLE_LEN = 0.5
POLE_MASS_LEN = MASS_POLE * HALF_POLE_LEN
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * np.pi / 360
X_THRESHOLD = 2.4


class CartPoleVectorEnv(VectorEnv):
    def __init__(self, num_envs: int, max_episode_steps: int = 500):
        self.num_envs = num_envs
        self.obs_dim = 4
        self.num_actions = 2
        self.max_episode_steps = max_episode_steps
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)
        self._rng = np.random.default_rng(0)

    def _sample_state(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, size=(n, 4))

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._sample_state(self.num_envs)
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, FORCE_MAG, -FORCE_MAG)
        cos, sin = np.cos(theta), np.sin(theta)
        temp = (force + POLE_MASS_LEN * theta_dot**2 * sin) / TOTAL_MASS
        theta_acc = (GRAVITY * sin - cos * temp) / (
            HALF_POLE_LEN * (4.0 / 3.0 - MASS_POLE * cos**2 / TOTAL_MASS)
        )
        x_acc = temp - POLE_MASS_LEN * theta_acc * cos / TOTAL_MASS
        # Euler integration (the Gym default)
        x = x + TAU * x_dot
        x_dot = x_dot + TAU * x_acc
        theta = theta + TAU * theta_dot
        theta_dot = theta_dot + TAU * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1

        terminated = (
            (np.abs(x) > X_THRESHOLD) | (np.abs(theta) > THETA_THRESHOLD)
        )
        truncated = (~terminated) & (self._steps >= self.max_episode_steps)
        rewards = np.ones(self.num_envs, np.float32)

        done = terminated | truncated
        if done.any():
            n = int(done.sum())
            self._state[done] = self._sample_state(n)
            self._steps[done] = 0
        return self._state.astype(np.float32), rewards, terminated, truncated


register_env("CartPole-v1", CartPoleVectorEnv)

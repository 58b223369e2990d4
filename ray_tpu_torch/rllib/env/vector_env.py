"""The port's copy of ray_tpu/rllib/env/vector_env.py: the registry and the
gated gymnasium adapter (gymnasium is not installed on the GPU machine).

Vectorized environment interface for rollout workers.

Parity: rllib/env/vector_env.py (`VectorEnv`) — N environments stepped in
lockstep with auto-reset. Ours is numpy-batched (one `step()` moves all lanes)
because the rollout actors run on host CPUs; the policy forward pass is the
jitted part. gymnasium-backed envs are supported when the package is present,
but the built-in envs (CartPole) have no dependency.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np


class VectorEnv:
    """N lockstep environments with auto-reset.

    step() returns (obs, rewards, terminateds, truncateds) where `obs` is the
    *next* observation — already reset for lanes whose episode just ended
    (the pre-reset terminal observation is not surfaced; value bootstrapping
    uses the `truncateds` flag instead, see postprocessing.compute_gae).
    """

    num_envs: int
    obs_dim: int
    num_actions: int
    max_episode_steps: int

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(
        self, actions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError


class GymnasiumVectorEnv(VectorEnv):
    """Adapter over `gymnasium.vector.SyncVectorEnv` (gated import)."""

    def __init__(self, env_id: str, num_envs: int):
        import gymnasium as gym

        self._venv = gym.vector.SyncVectorEnv(
            [lambda: gym.make(env_id) for _ in range(num_envs)]
        )
        self.num_envs = num_envs
        space = self._venv.single_observation_space
        self.obs_dim = int(np.prod(space.shape))
        self.num_actions = int(self._venv.single_action_space.n)
        spec = self._venv.envs[0].spec
        self.max_episode_steps = int(spec.max_episode_steps or 10_000)

    def reset(self, seed=None):
        obs, _ = self._venv.reset(seed=seed)
        return obs.reshape(self.num_envs, -1).astype(np.float32)

    def step(self, actions):
        obs, rew, term, trunc, _ = self._venv.step(actions)
        return (
            obs.reshape(self.num_envs, -1).astype(np.float32),
            rew.astype(np.float32),
            term.astype(bool),
            trunc.astype(bool),
        )


_BUILTIN: Dict[str, Callable[[int], VectorEnv]] = {}


def register_env(name: str, factory: Callable[[int], VectorEnv]) -> None:
    """Register a custom vector-env factory (name → factory(num_envs))."""
    _BUILTIN[name] = factory


def make_vector_env(env: str, num_envs: int) -> VectorEnv:
    """Resolve an env name: built-in registry first, then gymnasium."""
    if env in _BUILTIN:
        return _BUILTIN[env](num_envs)
    try:
        return GymnasiumVectorEnv(env, num_envs)
    except ImportError:
        raise ValueError(
            f"unknown env {env!r}: not a registered built-in and gymnasium "
            f"is not installed (built-ins: {sorted(_BUILTIN)})"
        )

"""The port's copy of ray_tpu/rllib/env/multi_agent.py (numpy on the host).

Multi-agent environments (vectorized).

Parity: rllib/env/multi_agent_env.py (`MultiAgentEnv`) — observations,
actions, and rewards are dicts keyed by agent id; the built-in
MultiAgentCartPole mirrors the reference's example env of the same name
(N independent CartPole instances, one per agent). Vectorized the same way
as VectorEnv: every per-agent array carries `num_envs` lanes and lanes
auto-reset, so the runner needs no episode bookkeeping in the env.

Agents are homogeneous in observation/action space here (the common case
and what the shared-policy and per-agent-policy tests need); heterogeneous
spaces would only change the runner's buffer shapes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.env.cartpole import CartPoleVectorEnv


class MultiAgentVectorEnv:
    """Dict-keyed vector env: one obs/action/reward array per agent."""

    agent_ids: List[str]
    num_envs: int
    obs_dim: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]) -> Tuple[
        Dict[str, np.ndarray], Dict[str, np.ndarray],
        Dict[str, np.ndarray], Dict[str, np.ndarray],
    ]:
        """actions[agent] -> [N]; returns (obs, rewards, terminateds,
        truncateds), each a dict of [N]-shaped arrays keyed by agent."""
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentVectorEnv):
    """`num_agents` independent CartPoles per lane (reference example env)."""

    def __init__(self, num_agents: int = 2, num_envs: int = 8,
                 max_episode_steps: int = 500):
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self.num_envs = num_envs
        self._envs = {
            aid: CartPoleVectorEnv(num_envs, max_episode_steps)
            for aid in self.agent_ids
        }
        probe = self._envs[self.agent_ids[0]]
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        return {
            aid: env.reset(
                seed=None if seed is None else seed + 7919 * i
            )
            for i, (aid, env) in enumerate(self._envs.items())
        }

    def step(self, actions):
        obs, rew, term, trunc = {}, {}, {}, {}
        for aid, env in self._envs.items():
            obs[aid], rew[aid], term[aid], trunc[aid] = env.step(actions[aid])
        return obs, rew, term, trunc


_MULTI_AGENT_REGISTRY: Dict[str, Callable[..., MultiAgentVectorEnv]] = {
    "MultiAgentCartPole": MultiAgentCartPole,
}


def register_multi_agent_env(
    name: str, factory: Callable[..., MultiAgentVectorEnv]
) -> None:
    _MULTI_AGENT_REGISTRY[name] = factory


def make_multi_agent_env(env: str, num_envs: int,
                         **kwargs) -> MultiAgentVectorEnv:
    if env not in _MULTI_AGENT_REGISTRY:
        raise ValueError(
            f"unknown multi-agent env {env!r}; registered: "
            f"{sorted(_MULTI_AGENT_REGISTRY)}"
        )
    return _MULTI_AGENT_REGISTRY[env](num_envs=num_envs, **kwargs)

"""Multi-agent rollout collection: per-policy batches via a mapping fn.

Counterpart of ray_tpu/rllib/multi_agent_runner.py. Each agent's stream
is acted on by its mapped policy's weights, and at fragment end every
policy receives ONE SampleBatch holding all of its agents' (GAE-
postprocessed) rows. Several agents mapping to one policy id = shared-
policy training (the batch concatenates their streams). As in
env_runner.py, inference runs on the host CPU: each policy is a tree of
CPU tensors on one intra-op thread, policy i drawn from a CPU generator
seeded seed * 10_007 + worker_index + i (where the reference folds i
into its key), actions from one seeded seed * 10_007 + worker_index.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

import torch

from ray_tpu_torch.rllib.env.multi_agent import make_multi_agent_env
from ray_tpu_torch.rllib.env_runner import CPU, one_thread
from ray_tpu_torch.rllib.models import (
    categorical_logp,
    categorical_sample,
    mlp_actor_critic_apply,
    mlp_actor_critic_init,
    params_to,
)
from ray_tpu_torch.rllib.postprocessing import compute_gae_lanes
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class MultiAgentEnvRunner:
    def __init__(
        self,
        env: str,
        policy_mapping: Dict[str, str],
        num_envs: int = 8,
        hiddens=(64, 64),
        gamma: float = 0.99,
        lambda_: float = 0.95,
        seed: int = 0,
        worker_index: int = 0,
        env_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self.env = make_multi_agent_env(env, num_envs, **(env_kwargs or {}))
        self.policy_mapping = dict(policy_mapping)
        missing = set(self.env.agent_ids) - set(self.policy_mapping)
        if missing:
            raise ValueError(f"no policy mapped for agents {sorted(missing)}")
        self.policy_ids = sorted(set(self.policy_mapping.values()))
        self.gamma = gamma
        self.lambda_ = lambda_
        self.worker_index = worker_index

        base = seed * 10_007 + worker_index
        self._rng = torch.Generator().manual_seed(base)
        self.policies: Dict[str, Any] = {
            pid: mlp_actor_critic_init(
                torch.Generator().manual_seed(base + i),
                self.env.obs_dim, self.env.num_actions, tuple(hiddens), CPU,
            )
            for i, pid in enumerate(self.policy_ids)
        }

        self._obs = self.env.reset(seed=seed * 997 + worker_index)
        N = self.env.num_envs
        self._ep_ret = {a: np.zeros(N, np.float32) for a in self.env.agent_ids}
        self._ep_len = {a: np.zeros(N, np.int64) for a in self.env.agent_ids}
        # per-agent completed-episode history (reference: per-policy metrics)
        self._episode_returns: Dict[str, deque] = {
            a: deque(maxlen=100) for a in self.env.agent_ids
        }

    def set_weights(self, weights: Dict[str, Any]) -> None:
        self.policies.update(
            {pid: params_to(w, CPU) for pid, w in weights.items()})

    def get_weights(self) -> Dict[str, Any]:
        return self.policies

    def obs_space(self) -> Tuple[int, int]:
        return self.env.obs_dim, self.env.num_actions

    def sample(
        self, num_steps: int, weights: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Dict[str, SampleBatch], Dict[str, Any]]:
        """Returns ({policy_id: SampleBatch}, metrics). Rows are GAE-
        postprocessed per agent stream, then concatenated per policy."""
        if weights is not None:
            self.set_weights(weights)
        with one_thread():
            return self._sample(num_steps)

    def _sample(self, T: int):
        agents = self.env.agent_ids
        N = self.env.num_envs
        D = self.env.obs_dim
        buf = {
            a: {
                "obs": np.empty((T, N, D), np.float32),
                "actions": np.empty((T, N), np.int64),
                "logp": np.empty((T, N), np.float32),
                "vf": np.empty((T, N), np.float32),
                "rew": np.empty((T, N), np.float32),
                "term": np.empty((T, N), bool),
                "trunc": np.empty((T, N), bool),
            }
            for a in agents
        }
        obs = self._obs
        for t in range(T):
            actions = {}
            for a in agents:
                params = self.policies[self.policy_mapping[a]]
                logits, value = mlp_actor_critic_apply(
                    params, torch.from_numpy(obs[a]))
                act = categorical_sample(self._rng, logits)
                actions[a] = act.numpy()
                b = buf[a]
                b["obs"][t] = obs[a]
                b["actions"][t] = actions[a]
                b["logp"][t] = categorical_logp(logits, act).numpy()
                b["vf"][t] = value.numpy()
            obs, rewards, terminateds, truncateds = self.env.step(actions)
            for a in agents:
                b = buf[a]
                b["rew"][t] = rewards[a]
                b["term"][t] = terminateds[a]
                b["trunc"][t] = truncateds[a]
                self._ep_ret[a] += rewards[a]
                self._ep_len[a] += 1
                done = terminateds[a] | truncateds[a]
                if done.any():
                    for i in np.flatnonzero(done):
                        self._episode_returns[a].append(float(self._ep_ret[a][i]))
                    self._ep_ret[a][done] = 0.0
                    self._ep_len[a][done] = 0
        self._obs = obs

        # GAE per agent stream with that agent's policy bootstrap value
        per_policy: Dict[str, list] = {pid: [] for pid in self.policy_ids}
        for a in agents:
            pid = self.policy_mapping[a]
            b = buf[a]
            bootstrap = mlp_actor_critic_apply(
                self.policies[pid], torch.from_numpy(obs[a]))[1].numpy()
            adv, targets = compute_gae_lanes(
                b["rew"], b["vf"], bootstrap, b["term"], b["trunc"],
                gamma=self.gamma, lambda_=self.lambda_,
            )
            flat = lambda x: x.reshape((T * N,) + x.shape[2:])
            per_policy[pid].append(SampleBatch({
                SampleBatch.OBS: flat(b["obs"]),
                SampleBatch.ACTIONS: flat(b["actions"]),
                SampleBatch.ACTION_LOGP: flat(b["logp"]),
                SampleBatch.VF_PREDS: flat(b["vf"]),
                SampleBatch.REWARDS: flat(b["rew"]),
                SampleBatch.ADVANTAGES: flat(adv),
                SampleBatch.VALUE_TARGETS: flat(targets),
            }))
        batches = {
            pid: SampleBatch.concat_samples(parts) for pid, parts in per_policy.items()
        }
        metrics = {
            # num_env_steps counts ENV steps (T ticks x N vector envs), the
            # same contract as the single-agent runner — so PPO's
            # train_batch_size means the same thing in both paths; per-agent
            # experience volume is reported separately as agent-steps
            "num_env_steps": T * N,
            "num_agent_steps": T * N * len(agents),
            "worker_index": self.worker_index,
            "episode_returns_per_agent": {
                a: list(self._episode_returns[a]) for a in agents
            },
        }
        return batches, metrics

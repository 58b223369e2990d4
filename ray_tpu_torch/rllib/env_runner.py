"""EnvRunner: the rollout worker, on the host CPU.

Counterpart of ray_tpu/rllib/env_runner.py. The runner owns a vector env
and a policy copy and produces postprocessed SampleBatches. Rollout
inference runs on the host CPU by design, as the reference pins it there
(`jax.default_device(cpu)`): the env is host code and the accelerator
belongs to the learner. So the policy copy is a tree of CPU tensors and
actions are drawn from a CPU torch.Generator, seeded as the reference
seeds its key (seed * 10_007 + worker_index); the env resets with
seed * 997 + worker_index. Weights arrive from the learner as a tree of
numpy arrays and are taken as CPU tensors without a copy. Each step's
inference is a few ops on [num_envs, 64] tensors, which run on one
intra-op thread (`one_thread`): splitting an op that small over a
thread pool costs more than the op, as much as 60× on a host whose CPU
share is less than its visible cores.

The runner runs inline in the driver or as a remote actor, a CPU worker
process with no GPU lease (algorithm.py): it never opens the card.
"""

from __future__ import annotations

from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.env.vector_env import make_vector_env
from ray_tpu_torch.rllib.models import (
    categorical_logp,
    categorical_sample,
    mlp_actor_critic_apply,
    mlp_actor_critic_init,
    params_to,
)
from ray_tpu_torch.rllib.postprocessing import compute_gae_lanes
from ray_tpu_torch.rllib.sample_batch import SampleBatch

CPU = torch.device("cpu")


@contextmanager
def one_thread():
    """Host inference on one intra-op thread (module docstring), no
    autograd; the caller's thread count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            yield
    finally:
        torch.set_num_threads(n)


class EnvRunner:
    def __init__(
        self,
        env: str,
        num_envs: int = 8,
        hiddens=(64, 64),
        gamma: float = 0.99,
        lambda_: float = 0.95,
        seed: int = 0,
        worker_index: int = 0,
        postprocess: str = "gae",
        act_mode: str = "categorical",
    ):
        self.env = make_vector_env(env, num_envs)
        self.gamma = gamma
        self.lambda_ = lambda_
        self.worker_index = worker_index
        # "gae": flat [T*N] rows with advantages attached (PPO and friends).
        # "vtrace": time-major [T, N] rows + behavior logp + bootstrap obs —
        # the learner computes advantages itself (IMPALA; the actor's value
        # head is stale by design there).
        # "transitions": flat (obs, action, reward, next_obs, done) rows for
        # replay-buffer algorithms (DQN and friends).
        self.postprocess = postprocess
        # "categorical": sample from the policy head's distribution.
        # "epsilon_greedy": the policy head is Q-VALUES; argmax with
        # epsilon-random exploration (pass epsilon to sample()).
        self.act_mode = act_mode
        self.epsilon = 1.0
        self._rng = torch.Generator().manual_seed(seed * 10_007 + worker_index)
        self.params = mlp_actor_critic_init(
            self._rng, self.env.obs_dim, self.env.num_actions, hiddens, CPU
        )

        self._obs = self.env.reset(seed=seed * 997 + worker_index)
        # per-lane running episode return/length + completed-episode history
        self._ep_ret = np.zeros(num_envs, np.float32)
        self._ep_len = np.zeros(num_envs, np.int64)
        self._episode_returns: deque = deque(maxlen=100)
        self._episode_lengths: deque = deque(maxlen=100)
        self._eps_base = worker_index * 1_000_000_000
        self._eps_id = np.arange(num_envs, dtype=np.int64) + self._eps_base
        self._next_eps = num_envs

    def set_weights(self, params) -> None:
        self.params = params_to(params, CPU)

    def get_weights(self):
        return self.params

    def obs_space(self) -> Tuple[int, int]:
        return self.env.obs_dim, self.env.num_actions

    def sample(
        self, num_steps: int, params: Optional[Any] = None,
        epsilon: Optional[float] = None,
    ) -> Tuple[SampleBatch, Dict[str, Any]]:
        """Roll `num_steps` env steps per lane; return (batch, metrics).

        Batch rows are time-major flattened ([T*N]) with GAE advantages and
        value targets already attached.
        """
        if params is not None:
            self.set_weights(params)
        if epsilon is not None:
            self.epsilon = float(epsilon)
        with one_thread():
            return self._sample(num_steps)

    def _act(self, obs: np.ndarray):
        logits, value = mlp_actor_critic_apply(self.params, torch.from_numpy(obs))
        actions = categorical_sample(self._rng, logits)
        logp = categorical_logp(logits, actions)
        return actions.numpy(), logp.numpy(), value.numpy()

    def _act_eps(self, obs: np.ndarray) -> np.ndarray:
        q, _ = mlp_actor_critic_apply(self.params, torch.from_numpy(obs))
        greedy = torch.argmax(q, dim=-1)
        rand = torch.randint(0, q.shape[-1], greedy.shape, generator=self._rng)
        explore = torch.rand(greedy.shape, generator=self._rng) < self.epsilon
        return torch.where(explore, rand, greedy).numpy()

    def _value(self, obs: np.ndarray) -> np.ndarray:
        return mlp_actor_critic_apply(self.params, torch.from_numpy(obs))[1].numpy()

    def _sample(self, num_steps: int) -> Tuple[SampleBatch, Dict[str, Any]]:
        N = self.env.num_envs
        T = num_steps
        obs_buf = np.empty((T, N, self.env.obs_dim), np.float32)
        act_buf = np.empty((T, N), np.int64)
        logp_buf = np.empty((T, N), np.float32)
        vf_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), bool)
        trunc_buf = np.empty((T, N), bool)
        eps_buf = np.empty((T, N), np.int64)

        transitions = self.postprocess == "transitions"
        next_obs_buf = (
            np.empty((T, N, self.env.obs_dim), np.float32)
            if transitions else None
        )

        obs = self._obs
        for t in range(T):
            if self.act_mode == "epsilon_greedy":
                actions = self._act_eps(obs)
                logp_buf[t] = 0.0
                vf_buf[t] = 0.0
            else:
                actions, logp_buf[t], vf_buf[t] = self._act(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            eps_buf[t] = self._eps_id
            obs, rewards, terminated, truncated = self.env.step(actions)
            if transitions:
                # NB: at auto-reset boundaries this is the RESET obs, not the
                # true terminal successor — harmless for bootstrapping since
                # the (1 - done) mask zeroes those targets (truncations are
                # treated as terminal, the standard replay shortcut).
                next_obs_buf[t] = obs
            rew_buf[t] = rewards
            term_buf[t] = terminated
            trunc_buf[t] = truncated
            self._ep_ret += rewards
            self._ep_len += 1
            done = terminated | truncated
            if done.any():
                for i in np.flatnonzero(done):
                    self._episode_returns.append(float(self._ep_ret[i]))
                    self._episode_lengths.append(int(self._ep_len[i]))
                    self._eps_id[i] = self._eps_base + self._next_eps
                    self._next_eps += 1
                self._ep_ret[done] = 0.0
                self._ep_len[done] = 0
        self._obs = obs

        metrics = {
            "episode_returns": list(self._episode_returns),
            "episode_lengths": list(self._episode_lengths),
            "num_env_steps": T * N,
            "worker_index": self.worker_index,
        }
        if transitions:
            def flat(x):
                return x.reshape((T * N,) + x.shape[2:])

            batch = SampleBatch({
                SampleBatch.OBS: flat(obs_buf),
                SampleBatch.ACTIONS: flat(act_buf),
                SampleBatch.REWARDS: flat(rew_buf),
                SampleBatch.NEXT_OBS: flat(next_obs_buf),
                SampleBatch.TERMINATEDS: flat(term_buf),
                SampleBatch.TRUNCATEDS: flat(trunc_buf),
                SampleBatch.EPS_ID: flat(eps_buf),
            })
            return batch, metrics

        if self.postprocess == "vtrace":
            batch = SampleBatch({
                SampleBatch.OBS: obs_buf,              # [T, N, D]
                SampleBatch.ACTIONS: act_buf,          # [T, N]
                SampleBatch.REWARDS: rew_buf,
                SampleBatch.TERMINATEDS: term_buf,
                SampleBatch.TRUNCATEDS: trunc_buf,
                SampleBatch.ACTION_LOGP: logp_buf,     # behavior policy
                "_bootstrap_obs": np.asarray(obs, np.float32),  # [N, D]
            })
            return batch, metrics

        bootstrap = self._value(obs)
        advantages, value_targets = compute_gae_lanes(
            rew_buf, vf_buf, bootstrap, term_buf, trunc_buf,
            gamma=self.gamma, lambda_=self.lambda_,
        )

        def flat(x):
            return x.reshape((T * N,) + x.shape[2:])

        batch = SampleBatch({
            SampleBatch.OBS: flat(obs_buf),
            SampleBatch.ACTIONS: flat(act_buf),
            SampleBatch.REWARDS: flat(rew_buf),
            SampleBatch.TERMINATEDS: flat(term_buf),
            SampleBatch.TRUNCATEDS: flat(trunc_buf),
            SampleBatch.ACTION_LOGP: flat(logp_buf),
            SampleBatch.VF_PREDS: flat(vf_buf),
            SampleBatch.ADVANTAGES: flat(advantages),
            SampleBatch.VALUE_TARGETS: flat(value_targets),
            SampleBatch.EPS_ID: flat(eps_buf),
        })
        return batch, metrics

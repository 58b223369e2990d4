"""DQN: off-policy Q-learning with replay, target network, and double-Q.

Counterpart of ray_tpu/rllib/algorithms/dqn.py. The rollout loop
(epsilon-greedy, on the local runner) and the replay buffer stay on the
host CPU, as in the reference: they are branchy row bookkeeping, not
tensor math. The learner runs on `learner_device` (the card unless the
caller asks for the CPU): each update is one optimizer step on the whole
sampled batch in its given order (double-Q target, Huber TD loss with the
PER importance weights, the reference's Adam chain), and reads the device
once, when its loss, mean Q and |TD| errors cross to the host together
for the buffer's priorities.

The target network is a copy of the parameters, made at the start and
again every target_update_freq updates, after that update's step. (The
reference's sync shares immutable arrays; a tensor shared with the live
parameters would follow every later step.)

Tuned target (mirrors rllib/tuned_examples/dqn/cartpole-dqn.yaml):
CartPole-v1 episode_reward_mean >= 150.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (
    LearnerGroup, TreeLearner, transition_columns,
)
from ray_tpu_torch.rllib.models import (
    mlp_actor_critic_apply, mlp_actor_critic_init, tree_leaves, tree_map,
)
from ray_tpu_torch.rllib.replay_buffers import (
    PrioritizedReplayBuffer, ReplayBuffer,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def take(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """q [B, A] at each row's action [B] → [B]."""
    return torch.gather(q, -1, actions[:, None])[:, 0]


def copy_tree(tree):
    """Fresh tensors holding the tree's values, outside autograd."""
    return tree_map(lambda p: p.detach().clone(), tree)


class DQNLearner(TreeLearner):
    """Double-DQN update with a periodically synced target network.

    The Q-network is the shared MLP module (models.py) with the policy
    head read as Q-values, so runner and learner exchange one tree format
    across every algorithm; its value head is unused and takes zero
    gradients, as under optax.
    """

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hiddens: Sequence[int] = (64, 64),
        lr: float = 5e-4,
        grad_clip: float = 10.0,
        gamma: float = 0.99,
        double_q: bool = True,
        target_update_freq: int = 50,
        huber_delta: float = 1.0,
        seed: int = 0,
        device="cuda",
    ):
        self.gamma = gamma
        self.double_q = double_q
        self.target_update_freq = max(1, target_update_freq)
        self.huber_delta = huber_delta
        # drawn on the host: a learner on the card and one on the CPU start
        # from the same weights
        super().__init__(
            mlp_actor_critic_init(torch.Generator().manual_seed(seed), obs_dim,
                                  num_actions, hiddens, device),
            lr, grad_clip, device)
        self.target = copy_tree(self.params)

    def loss_fn(self, params, mb):
        q_all, _ = mlp_actor_critic_apply(params, mb["obs"])
        qa = take(q_all, mb["actions"])
        with torch.no_grad():  # the reference's stop_gradient of the target
            qn_target, _ = mlp_actor_critic_apply(self.target, mb["next_obs"])
            if self.double_q:
                qn_online, _ = mlp_actor_critic_apply(params, mb["next_obs"])
                next_a = torch.argmax(qn_online, dim=-1)
            else:
                next_a = torch.argmax(qn_target, dim=-1)
            q_next = take(qn_target, next_a)
            target = mb["rewards"] + self.gamma * (1.0 - mb["dones"]) * q_next
        td = qa - target
        delta = self.huber_delta
        huber = torch.where(
            torch.abs(td) <= delta,
            0.5 * td**2,
            delta * (torch.abs(td) - 0.5 * delta),
        )
        loss = torch.mean(mb["weights"] * huber)
        return loss, {"td": td, "mean_q": torch.mean(qa)}

    @torch.no_grad()
    def _sync_target(self) -> None:
        for t, p in zip(tree_leaves(self.target), self._leaves):
            t.copy_(p)

    def update(self, batch: SampleBatch) -> Dict[str, Any]:
        loss, aux = self.loss_fn(self.params, transition_columns(batch, self.device))
        self._apply_gradients(loss)
        if self._step % self.target_update_freq == 0:
            self._sync_target()
        host = torch.cat([loss.detach()[None], aux["mean_q"].detach()[None],
                          torch.abs(aux["td"].detach())]).tolist()
        return {
            "loss": host[0],
            "mean_q": host[1],
            "td_errors": np.asarray(host[2:], np.float32),
            "num_updates": self._step,
        }


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 5e-4
        self.train_batch_size = 64
        self.rollout_fragment_length = 4
        self.num_envs_per_worker = 8
        self.grad_clip = 10.0
        # off-policy knobs
        self.buffer_capacity = 50_000
        self.prioritized_replay = True
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.learning_starts = 1_000
        self.target_update_freq = 100
        self.double_q = True
        self.huber_delta = 1.0
        self.train_intensity = 8       # learner updates per training_step
        # epsilon-greedy exploration schedule (linear by env steps)
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_timesteps = 10_000
        # (the base .training() setattr's any attribute defined above)


def make_replay_buffer(cfg: AlgorithmConfig) -> ReplayBuffer:
    """The config's buffer, on the host: prioritized or uniform."""
    if not cfg.prioritized_replay:
        return ReplayBuffer(capacity=cfg.buffer_capacity, seed=cfg.seed)
    return PrioritizedReplayBuffer(
        capacity=cfg.buffer_capacity, alpha=cfg.prioritized_replay_alpha,
        beta=cfg.prioritized_replay_beta, seed=cfg.seed)


def replay_training_step(algo: Algorithm, **sample_kwargs) -> Dict[str, Any]:
    """DQN's and SAC's iteration (the reference writes it out in each):
    one fragment from the local runner into the buffer, then, once the
    buffer holds learning_starts rows, train_intensity updates on sampled
    batches, each update's |TD| errors fed back as priorities."""
    cfg = algo.algo_config
    batch, metrics = algo.local_runner.sample(
        cfg.rollout_fragment_length, algo._weights, **sample_kwargs)
    algo.buffer.add(batch)
    algo._env_steps += len(batch)
    algo._merge_episode_metrics(metrics)

    learn_metrics: Dict[str, Any] = {}
    if len(algo.buffer) >= cfg.learning_starts:
        for _ in range(cfg.train_intensity):
            mb = algo.buffer.sample(cfg.train_batch_size)
            m = algo.learner_group.update(mb)
            td = m.pop("td_errors", None)
            if td is not None and hasattr(algo.buffer, "update_priorities"):
                algo.buffer.update_priorities(mb["batch_indexes"], td)
            learn_metrics = m
        algo._weights = algo.learner_group.get_weights()

    stats = algo._episode_stats()
    stats.update(learn_metrics)
    stats["buffer_size"] = len(algo.buffer)
    stats["timesteps_this_iter"] = len(batch)
    return stats


class DQN(Algorithm):
    """The replay buffer and the env-step count live in the algorithm, not
    in the learner: a checkpoint holds the learner's state only, as the
    reference's does, so a restored DQN starts again at epsilon_start and
    refills its buffer up to learning_starts (ROADMAP.md Queue C)."""

    config_class = DQNConfig

    def _runner_kwargs_extra(self) -> Dict[str, Any]:
        return {"postprocess": "transitions", "act_mode": "epsilon_greedy"}

    def _make_learner_group(self) -> LearnerGroup:
        cfg = self.algo_config
        self.buffer = make_replay_buffer(cfg)
        self._env_steps = 0
        return LearnerGroup(
            DQNLearner,
            dict(
                obs_dim=self.obs_dim,
                num_actions=self.num_actions,
                hiddens=tuple(cfg.hiddens),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                gamma=cfg.gamma,
                double_q=cfg.double_q,
                target_update_freq=cfg.target_update_freq,
                huber_delta=cfg.huber_delta,
                seed=cfg.seed,
                device=cfg.learner_device,
            ),
            mode=cfg.learner_mode,
        )

    def _epsilon(self) -> float:
        cfg = self.algo_config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def training_step(self) -> Dict[str, Any]:
        eps = self._epsilon()
        stats = replay_training_step(self, epsilon=eps)
        stats["epsilon"] = eps
        return stats

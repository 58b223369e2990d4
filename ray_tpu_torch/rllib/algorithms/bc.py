"""Behavior Cloning: supervised policy learning from logged experience.

Counterpart of ray_tpu/rllib/algorithms/bc.py (+ offline.py as the input
path): maximize the log-likelihood of the dataset's actions under the
policy. The logged rows are read once (JsonReader) into a ReplayBuffer
on the host CPU; the learner runs on `learner_device` (the card unless
the caller asks for the CPU), one cross-entropy step on each sampled
batch. Each iteration ends with an evaluation rollout on the local runner
(host CPU, categorical acting), so episode_reward_mean is comparable to
the online algorithms' reports.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import LearnerGroup, TreeLearner
from ray_tpu_torch.rllib.models import (
    categorical_logp, mlp_actor_critic_apply, mlp_actor_critic_init,
)
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch, columns_to


class BCLearner(TreeLearner):
    """One step of −mean(log π(a|s)) an update; the value head, unused,
    takes zero gradients, as under optax."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), lr: float = 1e-3,
                 grad_clip: float = 10.0, seed: int = 0, device="cuda"):
        # drawn on the host: a learner on the card and one on the CPU start
        # from the same weights
        super().__init__(
            mlp_actor_critic_init(torch.Generator().manual_seed(seed), obs_dim,
                                  num_actions, hiddens, device),
            lr, grad_clip, device)

    def loss_fn(self, params, mb):
        logits, _ = mlp_actor_critic_apply(params, mb["obs"])
        return -torch.mean(categorical_logp(logits, mb["actions"])), {}

    def update(self, batch: SampleBatch) -> Dict[str, Any]:
        loss, _ = self.loss_fn(self.params, columns_to({
            "obs": np.asarray(batch[SampleBatch.OBS], np.float32),
            "actions": np.asarray(batch[SampleBatch.ACTIONS], np.int64),
        }, self.device))
        self._apply_gradients(loss)
        return {"loss": loss.item()}


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.input_path: str = ""
        self.train_batch_size = 256
        self.train_intensity = 32      # learner updates per training_step
        self.lr = 1e-3

    def offline_data(self, input_path: str) -> "BCConfig":
        self.input_path = input_path
        return self


class BC(Algorithm):
    config_class = BCConfig

    def _make_learner_group(self) -> LearnerGroup:
        cfg = self.algo_config
        if not cfg.input_path:
            raise ValueError("BCConfig.offline_data(input_path=...) required")
        data = JsonReader(cfg.input_path).read_all()
        self.buffer = ReplayBuffer(capacity=max(len(data), 1), seed=cfg.seed)
        self.buffer.add(data)
        return LearnerGroup(
            BCLearner,
            dict(
                obs_dim=self.obs_dim,
                num_actions=self.num_actions,
                hiddens=tuple(cfg.hiddens),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                seed=cfg.seed,
                device=cfg.learner_device,
            ),
            mode=cfg.learner_mode,
        )

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.train_intensity):
            mb = self.buffer.sample(cfg.train_batch_size)
            metrics = self.learner_group.update(mb)
        self._weights = self.learner_group.get_weights()

        # evaluation rollout with the cloned policy (categorical acting)
        _, ep = self.local_runner.sample(cfg.rollout_fragment_length, self._weights)
        self._merge_episode_metrics(ep)
        stats = self._episode_stats()
        stats.update(metrics)
        stats["dataset_size"] = len(self.buffer)
        return stats

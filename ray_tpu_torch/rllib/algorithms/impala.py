"""IMPALA: async actors stream v-trace-corrected batches at a hot learner.

Counterpart of ray_tpu/rllib/algorithms/impala.py. Parity:
rllib/algorithms/impala/impala.py:554 (`IMPALA.training_step`) — the
async topology: every rollout worker always has a sample() request in
flight; the learner consumes whichever batch lands first and pushes fresh
weights back only to the worker being re-armed. Actors therefore act with
stale policies — the v-trace importance correction (vtrace.py) is what
makes the off-policy gradient sound. Rollout actors are CPU processes;
the learner (on `learner_device`, the card by default) takes one v-trace
step a batch. With num_rollout_workers=0 it samples inline
(`_training_step_sync`): sample a fragment on the local runner, update,
hand the weights back, updates_per_iteration times.
"""

from __future__ import annotations

import time
from typing import Any, Dict

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import IMPALALearner, LearnerGroup


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        # updates consumed per training_step() call (async: each waits only
        # for the next ready batch)
        self.updates_per_iteration = 8
        self.lr = 5e-4
        self.num_epochs = 1            # IMPALA: single pass per batch
        # (the base .training() setattr's any attribute defined above)


class IMPALA(Algorithm):
    config_class = IMPALAConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        self._inflight: Dict[Any, Any] = {}   # ref -> worker
        self._steps_sampled = 0
        self._t_start = time.monotonic()

    def _runner_kwargs_extra(self) -> Dict[str, Any]:
        # rollout workers sample WITHOUT GAE postprocessing — the learner
        # computes v-trace advantages with its own (fresher) value head
        return {"postprocess": "vtrace"}

    def _make_learner_group(self) -> LearnerGroup:
        cfg = self.algo_config
        learner_kwargs = dict(
            obs_dim=self.obs_dim,
            num_actions=self.num_actions,
            hiddens=tuple(cfg.hiddens),
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            seed=cfg.seed,
            gamma=cfg.gamma,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff,
            clip_rho_threshold=cfg.clip_rho_threshold,
            clip_c_threshold=cfg.clip_c_threshold,
            device=cfg.learner_device,
        )
        return LearnerGroup(
            IMPALALearner, learner_kwargs, mode=cfg.learner_mode,
            remote_options=cfg.learner_remote_options,
        )

    # ------------------------------------------------------------- async loop
    def _arm(self, worker) -> None:
        """Fire the next sample() on a worker with the CURRENT weights."""
        cfg = self.algo_config
        ref = worker.sample.remote(cfg.rollout_fragment_length, self._weights)
        self._inflight[ref] = worker

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        if not self.workers:
            return self._training_step_sync()
        import ray_tpu_torch

        for w in self.workers:
            if w not in self._inflight.values():
                self._arm(w)

        metrics: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iteration):
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight), num_returns=1, timeout=120
            )
            if not ready:
                break
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch, rollout_metrics = ray_tpu_torch.get(ref, timeout=60)
            self._merge_episode_metrics(rollout_metrics)
            metrics = self.learner_group.update(batch)
            self._steps_sampled += rollout_metrics["num_env_steps"]
            # fresh weights ride the re-arm (per-worker async broadcast)
            self._weights = self.learner_group.get_weights()
            self._arm(worker)

        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        metrics.update(self._episode_stats())
        metrics["timesteps_this_iter"] = self._steps_sampled - getattr(
            self, "_steps_reported", 0
        )
        self._steps_reported = self._steps_sampled
        metrics["env_steps_per_sec"] = self._steps_sampled / elapsed
        return metrics

    def _training_step_sync(self) -> Dict[str, Any]:
        """num_rollout_workers=0: sample inline, update, repeat."""
        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        steps = 0
        for _ in range(cfg.updates_per_iteration):
            batch, rollout_metrics = self.local_runner.sample(
                cfg.rollout_fragment_length, self._weights
            )
            self._merge_episode_metrics(rollout_metrics)
            metrics = self.learner_group.update(batch)
            self._weights = self.learner_group.get_weights()
            steps += rollout_metrics["num_env_steps"]
        self._steps_sampled += steps
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        metrics.update(self._episode_stats())
        metrics["timesteps_this_iter"] = steps
        metrics["env_steps_per_sec"] = self._steps_sampled / elapsed
        return metrics

"""IMPALA: v-trace-corrected actor-critic, sampled inline.

Counterpart of ray_tpu/rllib/algorithms/impala.py's synchronous path
(`_training_step_sync`, the reference's num_rollout_workers=0 case):
each iteration runs updates_per_iteration rounds of sample a fragment on
the local runner (host CPU, "vtrace" batches: time-major rows, behavior
logp and bootstrap obs), update the learner (on `learner_device`, the
card by default) with one v-trace step, hand its weights back. The
reference's asynchronous loop, rollout actors streaming batches at the
learner with stale weights, stands on the runtime planes and is refused
(ROADMAP.md Queue A item 5).
"""

from __future__ import annotations

import time
from typing import Any, Dict

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (
    REMOTE_REFUSAL, IMPALALearner, LearnerGroup,
)


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        # sample-and-update rounds per training_step() call
        self.updates_per_iteration = 8
        self.lr = 5e-4
        self.num_epochs = 1            # IMPALA: single pass per batch
        # (the base .training() setattr's any attribute defined above)


class IMPALA(Algorithm):
    config_class = IMPALAConfig

    def _refuse_remote(self, cfg: AlgorithmConfig) -> None:
        if cfg.num_rollout_workers > 0:
            raise NotImplementedError(
                f"IMPALA with num_rollout_workers={cfg.num_rollout_workers} "
                f"(its asynchronous training_step over rollout actors) "
                f"{REMOTE_REFUSAL}")
        super()._refuse_remote(cfg)

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
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
        )

    def training_step(self) -> Dict[str, Any]:
        """The reference's _training_step_sync: sample inline, update,
        repeat."""
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

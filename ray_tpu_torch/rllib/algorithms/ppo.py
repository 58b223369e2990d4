"""PPO: synchronous sample → multi-epoch clipped-surrogate SGD → weight sync.

Counterpart of ray_tpu/rllib/algorithms/ppo.py: sample on the runners
(host CPU, inline or on EnvRunner actors), update the learner (on
`learner_device`, the card by default) on the concatenated batch, then
hand its weights back to the runners. Single-agent, and multi-agent
when config.multi_agent() names policies (one learner per policy). Tuned
regression target: CartPole-v1 episode_reward_mean >= 150 within 100k
steps (rllib/tuned_examples/ppo/cartpole-ppo.yaml:4-6).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import LearnerGroup, PPOLearner


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01

    def training(self, **kwargs):
        for k in ("clip_param", "vf_clip_param", "vf_loss_coeff", "entropy_coeff"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        return super().training(**kwargs)


class PPO(Algorithm):
    config_class = PPOConfig

    # -------------------------------------------------------- multi-agent
    # Parity: the reference's PPO trains a policy_map when
    # config.multi_agent(policies=..., policy_mapping_fn=...) is set —
    # each policy gets its own learner, fed the concatenation of its
    # mapped agents' GAE'd streams (independent PPO; shared policy when
    # several agents map to one id).

    def setup(self, config: Dict[str, Any]) -> None:
        if self.algo_config.policies:
            self._setup_multi_agent()
        else:
            super().setup(config)

    def _setup_multi_agent(self) -> None:
        from ray_tpu_torch.rllib.env.multi_agent import make_multi_agent_env
        from ray_tpu_torch.rllib.multi_agent_runner import MultiAgentEnvRunner

        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("config.environment(env=...) is required")
        probe = make_multi_agent_env(cfg.env, 1, **cfg.env_kwargs)
        self.obs_dim, self.num_actions = probe.obs_dim, probe.num_actions
        pids = list(cfg.policies)
        fn = cfg.policy_mapping_fn
        if fn is None:
            # default: shared single policy, else round-robin agents
            fn = lambda aid: pids[probe.agent_ids.index(aid) % len(pids)]
        mapping = {aid: fn(aid) for aid in probe.agent_ids}
        unknown = set(mapping.values()) - set(pids)
        if unknown:
            raise ValueError(f"policy_mapping_fn returned unknown ids {unknown}")

        self._start_runners(MultiAgentEnvRunner, dict(
            env=cfg.env, policy_mapping=mapping,
            num_envs=cfg.num_envs_per_worker, hiddens=tuple(cfg.hiddens),
            gamma=cfg.gamma, lambda_=cfg.lambda_, seed=cfg.seed,
            env_kwargs=cfg.env_kwargs,
        ))
        self.policy_mapping = mapping
        self.learner_groups = {pid: self._make_learner_group() for pid in pids}
        self._ma_weights = {
            pid: g.get_weights() for pid, g in self.learner_groups.items()
        }
        # step() must keep this path's per-agent episode stats
        self._reports_own_episode_stats = True

    def _ma_training_step(self) -> Dict[str, Any]:
        import numpy as np

        cfg = self.algo_config
        from ray_tpu_torch.rllib.sample_batch import SampleBatch

        per_policy: Dict[str, list] = {pid: [] for pid in self.learner_groups}
        ep_returns: Dict[str, list] = {}
        steps = 0
        # rounds of fragments until train_batch_size TOTAL env steps, the
        # same contract as the single-agent sample_batch loop
        while steps < cfg.train_batch_size:
            ep_returns = {}
            for batches, metrics in self.sample_round(self._ma_weights):
                for pid, b in batches.items():
                    per_policy[pid].append(b)
                steps += metrics["num_env_steps"]
                # rolling windows: keep only the LATEST snapshot per agent
                for aid, rets in metrics["episode_returns_per_agent"].items():
                    ep_returns.setdefault(aid, []).extend(rets[-20:])
        stats: Dict[str, Any] = {"timesteps_this_iter": steps}
        for pid, parts in per_policy.items():
            if not parts:
                continue
            m = self.learner_groups[pid].update(
                SampleBatch.concat_samples(parts)
            )
            # the reference's key: None, since the learner reports
            # "total_loss" (ROADMAP.md Queue C)
            stats[f"policy/{pid}/loss"] = m.get("loss")
        self._ma_weights = {
            pid: g.get_weights() for pid, g in self.learner_groups.items()
        }
        per_agent = {
            aid: float(np.mean(r)) for aid, r in ep_returns.items() if r
        }
        stats["per_agent_reward_mean"] = per_agent
        if per_agent:
            stats["episode_reward_mean"] = float(
                np.mean(list(per_agent.values()))
            )
        return stats

    def _make_learner_group(self) -> LearnerGroup:
        cfg = self.algo_config
        learner_kwargs = dict(
            obs_dim=self.obs_dim,
            num_actions=self.num_actions,
            hiddens=tuple(cfg.hiddens),
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size,
            seed=cfg.seed,
            clip_param=getattr(cfg, "clip_param", 0.2),
            vf_clip_param=getattr(cfg, "vf_clip_param", 10.0),
            vf_loss_coeff=getattr(cfg, "vf_loss_coeff", 0.5),
            entropy_coeff=getattr(cfg, "entropy_coeff", 0.01),
            device=cfg.learner_device,
        )
        return LearnerGroup(
            PPOLearner, learner_kwargs, mode=cfg.learner_mode,
            remote_options=cfg.learner_remote_options,
        )

    def training_step(self) -> Dict[str, Any]:
        if self.algo_config.policies:
            return self._ma_training_step()
        train_batch = self.sample_batch()
        metrics = self.learner_group.update(train_batch)
        self._weights = self.learner_group.get_weights()
        metrics["timesteps_this_iter"] = len(train_batch)
        return metrics

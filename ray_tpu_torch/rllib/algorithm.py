"""Algorithm + AlgorithmConfig: the RLlib-equivalent driver layer.

Counterpart of ray_tpu/rllib/algorithm.py: every algorithm is a Trainable
(train()/save()/restore()) built by a fluent config, and
`training_step()` is the per-iteration hook each algorithm implements.

Rollouts run on the host CPU: inline in this process
(num_rollout_workers=0, one local EnvRunner) or on num_rollout_workers
EnvRunner actors, CPU worker processes of the runtime that never open
the card. The learner runs on `learner_device`, which `resources()` sets
and which defaults to "cuda": in this process (learner_mode="local") or
on one learner actor (learner_mode="remote", learner.py's LearnerGroup),
which holds a GPU lease when its device is a card.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Type

import numpy as np

from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    """Fluent config builder (subset of the reference's ~300 knobs)."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        # environment
        self.env: Optional[str] = None
        self.num_envs_per_worker = 8
        # rollouts
        self.num_rollout_workers = 0  # 0 = sample inline in the driver process
        self.rollout_fragment_length = 128
        # training
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.lr = 3e-4
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 10
        self.grad_clip = 0.5
        self.hiddens = (64, 64)
        self.seed = 0
        # learner placement
        self.learner_mode = "local"   # "local" | "remote" (one learner actor)
        self.learner_device = "cuda"  # where the learner's SGD runs
        # the remote learner actor's options (LearnerGroup adds a GPU
        # lease of one card when learner_device is a card)
        self.learner_remote_options: Dict[str, Any] = {"num_cpus": 1}
        # multi-agent (config.multi_agent()): policy ids + agent→policy map
        self.policies: Optional[List[str]] = None
        self.policy_mapping_fn: Optional[Any] = None
        self.env_kwargs: Dict[str, Any] = {}
        # extra per-algorithm knobs set by subclass-specific methods
        self.extra: Dict[str, Any] = {}

    # fluent sections, mirroring the reference's .environment()/.rollouts()/...
    def environment(self, env: str, num_envs_per_worker: Optional[int] = None,
                    env_kwargs: Optional[Dict[str, Any]] = None):
        self.env = env
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if env_kwargs is not None:
            self.env_kwargs = env_kwargs
        return self

    def multi_agent(self, policies=None, policy_mapping_fn=None):
        """Enable multi-agent training (parity: AlgorithmConfig.multi_agent).

        policies: list of policy ids. policy_mapping_fn(agent_id) -> policy
        id; default maps every agent to the single policy (shared policy)
        or round-robins agents over the given policies.
        """
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def rollouts(self, num_rollout_workers: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(self, k) and k != "extra":
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def resources(self, learner_mode: Optional[str] = None,
                  learner_device: Optional[str] = None,
                  learner_remote_options: Optional[Dict[str, Any]] = None):
        if learner_mode is not None:
            self.learner_mode = learner_mode
        if learner_device is not None:
            self.learner_device = learner_device
        if learner_remote_options is not None:
            self.learner_remote_options = learner_remote_options
        return self

    def debugging(self, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in vars(self).items() if k != "algo_class"}
        return copy.deepcopy(d)

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig()/...")
        return self.algo_class(config=self)


class Algorithm(Trainable):
    """Base driver: owns rollout workers + a LearnerGroup.

    Subclasses implement training_step() returning per-iteration metrics.
    Tune integration comes from Trainable (train/save/restore).
    """

    config_class: Type[AlgorithmConfig] = AlgorithmConfig

    def __init__(self, config: Any = None):
        if isinstance(config, AlgorithmConfig):
            self.algo_config = config
        else:
            self.algo_config = self.config_class().update_from_dict(dict(config or {}))
        super().__init__(self.algo_config.to_dict())

    # -- setup -------------------------------------------------------------- #
    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.rllib.env.vector_env import make_vector_env
        from ray_tpu_torch.rllib.env_runner import EnvRunner

        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("config.environment(env=...) is required")
        probe = make_vector_env(cfg.env, 1)
        self.obs_dim, self.num_actions = probe.obs_dim, probe.num_actions

        runner_kwargs = dict(
            env=cfg.env,
            num_envs=cfg.num_envs_per_worker,
            hiddens=tuple(cfg.hiddens),
            gamma=cfg.gamma,
            lambda_=cfg.lambda_,
            seed=cfg.seed,
            # algorithm-specific runner knobs (e.g. IMPALA's vtrace batches)
            **self._runner_kwargs_extra(),
        )
        self._start_runners(EnvRunner, runner_kwargs)
        self.learner_group = self._make_learner_group()
        self._weights = self.learner_group.get_weights()

    def _start_runners(self, runner_cls, runner_kwargs: Dict[str, Any]) -> None:
        """num_rollout_workers actors of runner_cls (CPU processes:
        num_cpus=1 and no GPU lease), or one local runner when there are
        none."""
        cfg = self.algo_config
        if cfg.num_rollout_workers > 0:
            import ray_tpu_torch

            remote_runner = ray_tpu_torch.remote(num_cpus=1)(runner_cls)
            self.workers = [
                remote_runner.remote(worker_index=i + 1, **runner_kwargs)
                for i in range(cfg.num_rollout_workers)
            ]
            self.local_runner = None
        else:
            self.workers = []
            self.local_runner = runner_cls(worker_index=0, **runner_kwargs)

    def _make_learner_group(self):
        raise NotImplementedError

    def _runner_kwargs_extra(self) -> Dict[str, Any]:
        """Subclass hook: extra EnvRunner kwargs (e.g. postprocess mode)."""
        return {}

    # -- rollout helpers ---------------------------------------------------- #
    def sample_round(self, weights, **sample_kwargs) -> List[Any]:
        """One fragment from every runner with `weights`: the remote
        runners' in parallel, the weights `put` once for the round; the
        local runner's inline. Returns their (batch, metrics) pairs."""
        cfg = self.algo_config
        if self.workers:
            import ray_tpu_torch

            weights_ref = ray_tpu_torch.put(weights)
            return ray_tpu_torch.get([
                w.sample.remote(cfg.rollout_fragment_length, weights_ref,
                                **sample_kwargs)
                for w in self.workers
            ])
        return [self.local_runner.sample(
            cfg.rollout_fragment_length, weights, **sample_kwargs)]

    def sample_batch(self):
        """Synchronous parallel sampling across all runners.

        Parity: rllib/execution/rollout_ops.py synchronous_parallel_sample.
        Loops rounds of fragment-length rollouts until train_batch_size rows.
        """
        from ray_tpu_torch.rllib.sample_batch import SampleBatch

        cfg = self.algo_config
        batches: List[SampleBatch] = []
        total = 0
        while total < cfg.train_batch_size:
            for batch, metrics in self.sample_round(self._weights):
                batches.append(batch)
                total += len(batch)
                self._merge_episode_metrics(metrics)
        return SampleBatch.concat_samples(batches)

    def _merge_episode_metrics(self, metrics: Dict[str, Any]) -> None:
        # runner sends its full rolling window each time; replace per worker
        self._runner_windows = getattr(self, "_runner_windows", {})
        self._runner_windows[metrics["worker_index"]] = (
            metrics["episode_returns"], metrics["episode_lengths"]
        )

    def _episode_stats(self) -> Dict[str, Any]:
        returns: List[float] = []
        lengths: List[int] = []
        for rets, lens in getattr(self, "_runner_windows", {}).values():
            returns.extend(rets)
            lengths.extend(lens)
        if not returns:
            return {"episode_reward_mean": float("nan"), "episodes_this_window": 0}
        return {
            "episode_reward_mean": float(np.mean(returns)),
            "episode_reward_max": float(np.max(returns)),
            "episode_reward_min": float(np.min(returns)),
            "episode_len_mean": float(np.mean(lengths)),
            "episodes_this_window": len(returns),
        }

    # -- Trainable ---------------------------------------------------------- #
    # subclasses whose training_step computes its own episode stats (the
    # multi-agent path reports per-agent windows) set this in setup()
    _reports_own_episode_stats = False

    def step(self) -> Dict[str, Any]:
        result = self.training_step()
        if not self._reports_own_episode_stats:
            result.update(self._episode_stats())
        return result

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _all_learner_groups(self) -> Dict[str, Any]:
        """Every learner group this algorithm owns, keyed for checkpoints:
        the single-agent one under "__single__", multi-agent ones per
        policy id."""
        groups: Dict[str, Any] = {}
        if getattr(self, "learner_group", None) is not None:
            groups["__single__"] = self.learner_group
        groups.update(getattr(self, "learner_groups", {}) or {})
        return groups

    def save_checkpoint(self, checkpoint_dir: str):
        # config rides along for inspection only (load_checkpoint ignores
        # it); strip callables — policy_mapping_fn is usually a lambda and
        # Trainable.save pickles this whole dict
        cfg = {k: v for k, v in self.algo_config.to_dict().items()
               if not callable(v)}
        return {
            "learner_state": {
                key: g.get_state() for key, g in self._all_learner_groups().items()
            },
            "config": cfg,
        }

    def load_checkpoint(self, checkpoint) -> None:
        groups = self._all_learner_groups()
        for key, s in checkpoint["learner_state"].items():
            groups[key].set_state(s)
        if getattr(self, "learner_group", None) is not None:
            self._weights = self.learner_group.get_weights()
        if getattr(self, "learner_groups", None):
            self._ma_weights = {
                pid: g.get_weights() for pid, g in self.learner_groups.items()
            }

    def get_weights(self):
        if getattr(self, "learner_groups", None):
            return self._ma_weights
        return self._weights

    def cleanup(self) -> None:
        for g in self._all_learner_groups().values():
            g.shutdown()
        if getattr(self, "workers", None):
            import ray_tpu_torch

            for w in self.workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001 - already dead / shutdown race
                    pass

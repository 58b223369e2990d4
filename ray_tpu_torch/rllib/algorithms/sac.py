"""SAC (discrete): maximum-entropy off-policy actor-critic.

Counterpart of ray_tpu/rllib/algorithms/sac.py: a categorical policy, twin
Q networks and a learned temperature. The rollout loop (the policy's own
sampling, act_mode "categorical": no epsilon schedule) and the replay
buffer stay on the host CPU, as in the reference. The learner runs on
`learner_device` (the card unless the caller asks for the CPU): each
update is one optimizer step on the whole sampled batch over every leaf
of {"log_alpha", "pi", "q1", "q2"} (twin soft-Q targets, the policy's
KL-to-Boltzmann loss, the temperature's loss), then polyak averaging of
the target Q networks, and one read of the device for the metrics and
the |TD| errors.

Every stop_gradient of the reference is a .detach() in the same place.
Each net is a whole actor-critic tree, so its value head, unused, takes
zero gradients, as does log_alpha when autotune_alpha is off.

Learning target (reference tuned-example spirit): CartPole-v1
episode_reward_mean >= 150.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import (
    copy_tree, make_replay_buffer, replay_training_step, take,
)
from ray_tpu_torch.rllib.learner import (
    LearnerGroup, TreeLearner, copy_into, transition_columns,
)
from ray_tpu_torch.rllib.models import (
    mlp_actor_critic_apply, mlp_actor_critic_init, params_to_numpy, tree_leaves,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

METRICS = ("loss", "q_loss", "pi_loss", "alpha", "policy_entropy")


def q_of(net, obs: torch.Tensor) -> torch.Tensor:
    """A Q network reads the module's policy head as Q-values."""
    return mlp_actor_critic_apply(net, obs)[0]


class SACLearner(TreeLearner):
    """Discrete-SAC update (twin Q + categorical policy + alpha)."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hiddens: Sequence[int] = (64, 64),
        lr: float = 3e-3,
        grad_clip: float = 10.0,
        gamma: float = 0.99,
        tau: float = 0.01,
        initial_alpha: float = 0.2,
        autotune_alpha: bool = True,
        target_entropy: float | None = None,
        seed: int = 0,
        device="cuda",
    ):
        self.gamma = gamma
        self.tau = tau
        self.autotune = autotune_alpha
        if target_entropy is None:
            # discrete-SAC convention: a high fraction of max entropy
            target_entropy = 0.6 * float(np.log(num_actions))
        self.target_entropy = target_entropy
        # drawn on the host, pi then q1 then q2: a learner on the card and
        # one on the CPU start from the same weights
        gen = torch.Generator().manual_seed(seed)
        nets = {k: mlp_actor_critic_init(gen, obs_dim, num_actions, hiddens, device)
                for k in ("pi", "q1", "q2")}
        log_alpha = torch.tensor(float(np.log(initial_alpha)), dtype=torch.float32,
                                 device=device)
        super().__init__({**nets, "log_alpha": log_alpha}, lr, grad_clip, device)
        self.target = {k: copy_tree(self.params[k]) for k in ("q1", "q2")}
        self._polyak_pairs = (
            tree_leaves(self.target),
            tree_leaves({k: self.params[k] for k in ("q1", "q2")}),
        )

    def loss_fn(self, p, mb):
        logits, _ = mlp_actor_critic_apply(p["pi"], mb["obs"])
        logpi = F.log_softmax(logits, dim=-1)
        pi_probs = torch.exp(logpi)
        alpha = torch.exp(p["log_alpha"])

        # ---- twin soft-Q targets from the NEXT state's policy
        nlogits, _ = mlp_actor_critic_apply(p["pi"], mb["next_obs"])
        nlogpi = F.log_softmax(nlogits, dim=-1)
        npi = torch.exp(nlogpi)
        tq = torch.minimum(q_of(self.target["q1"], mb["next_obs"]),
                           q_of(self.target["q2"], mb["next_obs"]))
        v_next = torch.sum(npi * (tq - alpha.detach() * nlogpi), dim=-1)
        y = mb["rewards"] + self.gamma * (1.0 - mb["dones"]) * v_next.detach()

        q1_all = q_of(p["q1"], mb["obs"])
        q2_all = q_of(p["q2"], mb["obs"])
        td1 = take(q1_all, mb["actions"]) - y
        td2 = take(q2_all, mb["actions"]) - y
        q_loss = torch.mean(mb["weights"] * (td1**2 + td2**2)) * 0.5

        # ---- policy: minimize E_pi[alpha*logpi - minQ] (Q frozen)
        q_min = torch.minimum(q1_all, q2_all).detach()
        pi_loss = torch.mean(
            torch.sum(pi_probs * (alpha.detach() * logpi - q_min), dim=-1))

        # ---- temperature: drive policy entropy toward the target
        entropy = -torch.sum((pi_probs * logpi).detach(), dim=-1)
        alpha_loss = torch.mean(
            torch.exp(p["log_alpha"]) * (entropy - self.target_entropy)
        ) if self.autotune else 0.0

        loss = q_loss + pi_loss + alpha_loss
        return loss, {"td": td1, "policy_entropy": torch.mean(entropy),
                      "alpha": alpha, "q_loss": q_loss, "pi_loss": pi_loss}

    @torch.no_grad()
    def _polyak(self) -> None:
        """target ← (1 − tau)·target + tau·online, rounded in that order
        (not torch.lerp's target + tau·(online − target))."""
        targets, online = self._polyak_pairs
        torch._foreach_mul_(targets, 1.0 - self.tau)
        torch._foreach_add_(targets, torch._foreach_mul(online, self.tau))

    def update(self, batch: SampleBatch) -> Dict[str, Any]:
        loss, aux = self.loss_fn(self.params, transition_columns(batch, self.device))
        self._apply_gradients(loss)
        self._polyak()
        host = torch.cat(
            [loss.detach()[None]]
            + [aux[k].detach()[None] for k in METRICS[1:]]
            + [torch.abs(aux["td"].detach())]).tolist()
        out: Dict[str, Any] = dict(zip(METRICS, host))
        out["td_errors"] = np.asarray(host[len(METRICS):], np.float32)
        out["num_updates"] = self._step
        return out

    # the env runner only needs the categorical policy module
    def get_weights(self):
        return params_to_numpy(self.params["pi"])

    @torch.no_grad()
    def set_weights(self, pi_params) -> None:
        copy_into(tree_leaves(self.params["pi"]), pi_params)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.lr = 3e-3
        self.train_batch_size = 128
        self.rollout_fragment_length = 4
        self.num_envs_per_worker = 8
        self.grad_clip = 10.0
        self.buffer_capacity = 50_000
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.learning_starts = 1_000
        self.tau = 0.01
        self.initial_alpha = 0.2
        self.autotune_alpha = True
        self.target_entropy: float | None = None
        self.train_intensity = 8
        # (the base .training() setattr's any attribute defined above)


class SAC(Algorithm):
    """Its buffer, like DQN's, is not in a checkpoint (dqn.py)."""

    config_class = SACConfig

    def _runner_kwargs_extra(self) -> Dict[str, Any]:
        # stochastic policy IS the exploration; replay-style transitions
        return {"postprocess": "transitions", "act_mode": "categorical"}

    def _make_learner_group(self) -> LearnerGroup:
        cfg = self.algo_config
        self.buffer = make_replay_buffer(cfg)
        self._env_steps = 0
        return LearnerGroup(
            SACLearner,
            dict(
                obs_dim=self.obs_dim,
                num_actions=self.num_actions,
                hiddens=tuple(cfg.hiddens),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                gamma=cfg.gamma,
                tau=cfg.tau,
                initial_alpha=cfg.initial_alpha,
                autotune_alpha=cfg.autotune_alpha,
                target_entropy=cfg.target_entropy,
                seed=cfg.seed,
                device=cfg.learner_device,
            ),
            mode=cfg.learner_mode,
            remote_options=cfg.learner_remote_options,
        )

    def training_step(self) -> Dict[str, Any]:
        return replay_training_step(self)

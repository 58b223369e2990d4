"""TorchLearner + LearnerGroup: the SGD side of the RL stack, on the card.

Counterpart of ray_tpu/rllib/learner.py (JaxLearner, PPOLearner,
IMPALALearner, LearnerGroup). The learner owns the accelerator: its
parameters and its optimizer's moments live on `device` ("cuda" unless
the caller asks for the CPU), while rollouts run on the host CPU
(env_runner.py). The optimizer is the reference's
optax.chain(clip_by_global_norm(grad_clip), adam(lr)): the port's
ClippedAdamW with no weight decay, b1 0.9, b2 0.999, eps 1e-8, f32
moments and a constant learning rate.

TreeLearner holds what every learner shares: a parameter tree on the
device (and a target tree, where the algorithm has a target network),
the optimizer over its leaves in JAX's sorted-key order, one optimizer
step from a loss, and the weight and state plumbing. TorchLearner adds
the reference's multi-epoch minibatch loop (PPO, IMPALA); the
off-policy and offline learners (algorithms/dqn.py, sac.py, bc.py) take
one step on the whole batch an update, in its given order.

The reference's PPO update is one jitted lax.scan over epochs and
shuffled minibatches, which meets the host once. Here the same loop runs
eagerly, each minibatch step a few hundred small kernels, and still meets
the host once: no value is read back inside the loop, each step's metrics
stay on the device, and their means cross to the host in one transfer at
the end. The minibatch arithmetic is the reference's: num_mb =
max(n // mb, 1) minibatches of min(mb, n) rows a epoch, from a fresh
permutation of the n rows each epoch, the remainder dropped; the k-th
permutation comes from a generator on the learner's device seeded with a
word drawn from (seed + 1, k) (the reference splits one key seeded
seed + 1), so the learner's state holds two integers for it, whatever
the device.

LearnerGroup runs the learner in-process (mode="local") or as one actor
of the runtime (mode="remote"), the reference's accelerator-owning
learner. An actor whose learner runs on a card holds a GPU lease of one
card (num_gpus=1) unless its options name num_gpus: a worker without a
lease sees every card, and the raylet may later lease that worker a card
it did not open (ROADMAP.md, the one-node runtime's deviations).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.models import (
    categorical_entropy,
    categorical_logp,
    host_tensor,
    mlp_actor_critic_apply,
    mlp_actor_critic_init,
    params_to_numpy,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch, columns_to
from ray_tpu_torch.rllib.vtrace import vtrace_from_logps
from ray_tpu_torch.train.train_step import ClippedAdamW

class TreeLearner:
    """A parameter tree on `device` and the reference's optimizer over its
    leaves (module docstring), with the weight and state plumbing every
    learner shares. A subclass builds the tree, and `target` where it has
    a target network (a second tree, which the optimizer does not step),
    and takes each optimizer step with `_apply_gradients`."""

    target = None

    def __init__(self, params, lr: float, grad_clip: float, device):
        self.device = torch.device(device)
        self.params = params
        self._leaves: List[torch.Tensor] = tree_leaves(params)
        for p in self._leaves:
            p.requires_grad_(True)
        self._optimizer = ClippedAdamW(
            self._leaves, schedule=lambda count: lr, weight_decay=0.0,
            b1=0.9, b2=0.999, grad_clip=grad_clip, eps=1e-8,
            moment_dtype=torch.float32,
        )
        self._step = 0

    def _apply_gradients(self, loss: torch.Tensor) -> None:
        """One optimizer step down the gradient of `loss`. A leaf the loss
        does not reach (a head the algorithm does not use) takes a zero
        gradient, as it does under optax, whose Adam moments decay over
        it; ClippedAdamW would skip a leaf whose gradient is None."""
        grads = torch.autograd.grad(loss, self._leaves, materialize_grads=True)
        for p, g in zip(self._leaves, grads):
            p.grad = g
        self._optimizer.step()
        self._step += 1

    # -- state -------------------------------------------------------------- #
    def get_weights(self):
        """The parameters as a tree of numpy arrays on the host."""
        return params_to_numpy(self.params)

    @torch.no_grad()
    def set_weights(self, params) -> None:
        copy_into(self._leaves, params)

    def get_state(self):
        """Parameters, target (where there is one), Adam's moments and
        count and the step, as numpy arrays and integers on the host:
        nothing in it depends on the device, so a state saved on the card
        restores on the CPU and the other way round."""
        state = self._optimizer.state
        out = {
            "params": params_to_numpy(self.params),
            "opt_state": {
                "mu": params_to_numpy(tree_map(lambda p: state[p]["mu"], self.params)),
                "nu": params_to_numpy(tree_map(lambda p: state[p]["nu"], self.params)),
                "count": self._optimizer.count,
            },
            "step": self._step,
        }
        if self.target is not None:
            out["target"] = params_to_numpy(self.target)
        return out

    @torch.no_grad()
    def set_state(self, state) -> None:
        """Puts a get_state() tree back, on the learner's device."""
        self.set_trees(state)
        opt = state["opt_state"]
        for name in ("mu", "nu"):
            copy_into([self._optimizer.state[p][name] for p in self._leaves],
                      opt[name])
        self._optimizer.count = int(opt["count"])
        self._step = int(state["step"])

    @torch.no_grad()
    def set_trees(self, trees) -> None:
        """The parameters, and the target where the learner has one, from
        trees of numpy arrays or tensors with the reference learner's
        layout ({"params": ..., "target": ...}, as jax.device_get of its
        state gives them), copied onto the learner's device."""
        copy_into(self._leaves, trees["params"])
        if self.target is not None:
            copy_into(tree_leaves(self.target), trees["target"])


def copy_into(dst: List[torch.Tensor], src_tree) -> None:
    """A tree of numpy arrays or tensors copied, leaf by leaf in
    tree_leaves' order, into the tensors `dst` (on their device)."""
    src = tree_leaves(src_tree)
    if len(src) != len(dst):
        raise ValueError(f"a tree of {len(src)} leaves for {len(dst)}")
    for d, s in zip(dst, src):
        d.copy_(host_tensor(s))


class TorchLearner(TreeLearner):
    """Holds the parameters and optimizer state on `device` and runs the
    multi-epoch update.

    Subclasses define `loss_fn(params, minibatch) -> (loss, aux)` as a
    function of its arguments; this class and TreeLearner build the
    optimizer, the update loop and the weight/state plumbing.
    """

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hiddens: Sequence[int] = (64, 64),
        lr: float = 3e-4,
        grad_clip: float = 0.5,
        num_epochs: int = 10,
        minibatch_size: int = 128,
        seed: int = 0,
        device="cuda",
    ):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        # drawn on the host, so a learner on the card and one on the CPU
        # start from the same weights
        super().__init__(
            mlp_actor_critic_init(torch.Generator().manual_seed(seed), obs_dim,
                                  num_actions, hiddens, device),
            lr, grad_clip, device)
        self._perm_seed, self._perm_draws = seed + 1, 0
        self._metric_keys: List[str] = []

    # -- subclass hook ------------------------------------------------------ #
    def loss_fn(self, params, minibatch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    # -- update ------------------------------------------------------------- #
    def _sgd_step(self, minibatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on `minibatch` → its metrics, stacked in
        `_metric_keys`' order, on the device."""
        loss, aux = self.loss_fn(self.params, minibatch)
        self._apply_gradients(loss)
        self._metric_keys = [*aux, "total_loss", "grad_norm"]
        return torch.stack([*(v.detach() for v in aux.values()),
                            loss.detach(), self._optimizer.grad_norm])

    def _metrics(self, rows: List[torch.Tensor], n: int) -> Dict[str, float]:
        """The means of the steps' metrics, read back in one transfer."""
        means = torch.stack(rows).mean(0).tolist()
        out = dict(zip(self._metric_keys, means))
        out["num_env_steps_trained"] = n
        return out

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        n = len(batch)
        arrays = self._prepare_batch(batch)
        num_mb = max(n // self.minibatch_size, 1)
        mb_eff = min(self.minibatch_size, n)
        rows = []
        for _ in range(self.num_epochs):
            idx = self._permutation(n)[: num_mb * mb_eff].view(num_mb, mb_eff)
            for i in range(num_mb):
                rows.append(self._sgd_step(
                    {k: v[idx[i]] for k, v in arrays.items()}))
        return self._metrics(rows, n)

    def _permutation(self, n: int) -> torch.Tensor:
        """The next epoch's permutation of n rows, on the device. (A CPU
        generator keeps 32 bits of its seed, hence one word.)"""
        word = np.random.SeedSequence(
            [self._perm_seed, self._perm_draws]).generate_state(1)[0]
        rng = torch.Generator(device=self.device).manual_seed(int(word))
        self._perm_draws += 1
        return torch.randperm(n, generator=rng, device=self.device)

    def _prepare_batch(self, batch: SampleBatch) -> Dict[str, torch.Tensor]:
        """Subclasses pick/transform columns; default passes every column."""
        return batch.as_torch(self.device)

    # -- state -------------------------------------------------------------- #
    def get_state(self):
        """TreeLearner's state and where the permutations have got to
        (their seed and the number drawn: two integers, whatever the
        device, so a restored learner draws that device's permutations
        from the same seeds). (The reference's state leaves its rng out,
        so its restored learner draws other permutations than the saved
        one would have.)"""
        return {**super().get_state(),
                "perm": {"seed": self._perm_seed, "draws": self._perm_draws}}

    @torch.no_grad()
    def set_state(self, state) -> None:
        super().set_state(state)
        self._perm_seed = int(state["perm"]["seed"])
        self._perm_draws = int(state["perm"]["draws"])


def transition_columns(batch: SampleBatch, device) -> Dict[str, torch.Tensor]:
    """A replay batch's columns as the off-policy learners (DQN, SAC) take
    them, on `device`: f32 obs, next_obs and rewards, int64 actions, the
    PER weights (1 without them) and done = clip(terminated + truncated,
    0, 1), computed on the host as the reference does. A truncation counts
    as terminal, so neither bootstraps past a time limit: a quirk of the
    reference, kept (ROADMAP.md Queue C)."""
    dones = (
        np.asarray(batch[SampleBatch.TERMINATEDS], np.float32)
        + np.asarray(batch[SampleBatch.TRUNCATEDS], np.float32)
    ).clip(0, 1)
    return columns_to({
        "obs": np.asarray(batch[SampleBatch.OBS], np.float32),
        "actions": np.asarray(batch[SampleBatch.ACTIONS], np.int64),
        "rewards": np.asarray(batch[SampleBatch.REWARDS], np.float32),
        "next_obs": np.asarray(batch[SampleBatch.NEXT_OBS], np.float32),
        "dones": dones,
        "weights": np.asarray(
            batch.get("weights", np.ones(len(batch), np.float32)), np.float32),
    }, device)


class PPOLearner(TorchLearner):
    """Clipped-surrogate PPO loss (Schulman et al. 2017), as the
    reference's: surrogate clip, clipped squared value error, entropy
    bonus, advantages standardised per train batch."""

    def __init__(
        self,
        *args,
        clip_param: float = 0.2,
        vf_clip_param: float = 10.0,
        vf_loss_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        **kwargs,
    ):
        self.clip_param = clip_param
        self.vf_clip_param = vf_clip_param
        self.vf_loss_coeff = vf_loss_coeff
        self.entropy_coeff = entropy_coeff
        super().__init__(*args, **kwargs)

    def _prepare_batch(self, batch: SampleBatch):
        # on the host in numpy, as the reference: population std (ddof 0)
        adv = np.asarray(batch[SampleBatch.ADVANTAGES], np.float32)
        adv = (adv - adv.mean()) / max(float(adv.std()), 1e-6)
        return columns_to({
            "obs": np.asarray(batch[SampleBatch.OBS], np.float32),
            "actions": np.asarray(batch[SampleBatch.ACTIONS], np.int64),
            "logp_old": np.asarray(batch[SampleBatch.ACTION_LOGP], np.float32),
            "vf_preds_old": np.asarray(batch[SampleBatch.VF_PREDS], np.float32),
            "advantages": adv,
            "value_targets": np.asarray(
                batch[SampleBatch.VALUE_TARGETS], np.float32),
        }, self.device)

    def loss_fn(self, params, mb):
        logits, value = mlp_actor_critic_apply(params, mb["obs"])
        logp = categorical_logp(logits, mb["actions"])
        ratio = torch.exp(logp - mb["logp_old"])
        adv = mb["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param) * adv,
        )
        policy_loss = -torch.mean(surrogate)
        vf_err = torch.clamp(
            (value - mb["value_targets"]) ** 2, 0.0, self.vf_clip_param ** 2
        )
        vf_loss = torch.mean(vf_err)
        entropy = torch.mean(categorical_entropy(logits))
        total = (
            policy_loss + self.vf_loss_coeff * vf_loss - self.entropy_coeff * entropy
        )
        aux = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": torch.mean(mb["logp_old"] - logp),
        }
        return total, aux


class IMPALALearner(TorchLearner):
    """V-trace actor-critic loss (IMPALA, Espeholt et al. 2018), as the
    reference's: policy gradient with clipped importance weights, baseline
    loss against v-trace targets, entropy bonus; one step over the whole
    time-major batch per update (no epochs, no minibatches)."""

    def __init__(
        self,
        *args,
        gamma: float = 0.99,
        vf_loss_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        clip_rho_threshold: float = 1.0,
        clip_c_threshold: float = 1.0,
        **kwargs,
    ):
        self.gamma = gamma
        self.vf_loss_coeff = vf_loss_coeff
        self.entropy_coeff = entropy_coeff
        self.clip_rho_threshold = clip_rho_threshold
        self.clip_c_threshold = clip_c_threshold
        super().__init__(*args, **kwargs)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        arrays = self._prepare_batch(batch)
        T, N = arrays["rewards"].shape
        return self._metrics([self._sgd_step(arrays)], T * N)

    def _prepare_batch(self, batch: SampleBatch):
        done = np.asarray(
            batch[SampleBatch.TERMINATEDS] | batch[SampleBatch.TRUNCATEDS]
        )
        return columns_to({
            "obs": np.asarray(batch[SampleBatch.OBS], np.float32),      # [T,N,D]
            "actions": np.asarray(batch[SampleBatch.ACTIONS], np.int64),  # [T,N]
            "behavior_logp": np.asarray(
                batch[SampleBatch.ACTION_LOGP], np.float32),
            "rewards": np.asarray(batch[SampleBatch.REWARDS], np.float32),
            "discounts": np.asarray(
                self.gamma * (1.0 - done.astype(np.float32)), np.float32),
            "bootstrap_obs": np.asarray(batch["_bootstrap_obs"], np.float32),
        }, self.device)

    def loss_fn(self, params, mb):
        T, N, D = mb["obs"].shape
        logits, values = mlp_actor_critic_apply(params, mb["obs"].reshape(T * N, D))
        logits = logits.reshape(T, N, -1)
        values = values.reshape(T, N)
        target_logp = categorical_logp(logits, mb["actions"])
        bootstrap_value = mlp_actor_critic_apply(params, mb["bootstrap_obs"])[1]

        vt = vtrace_from_logps(
            behavior_logp=mb["behavior_logp"],
            target_logp=target_logp,
            rewards=mb["rewards"],
            values=values,
            bootstrap_value=bootstrap_value,
            discounts=mb["discounts"],
            clip_rho_threshold=self.clip_rho_threshold,
            clip_c_threshold=self.clip_c_threshold,
        )
        pg_loss = -torch.mean(vt.pg_advantages * target_logp)
        vf_loss = 0.5 * torch.mean((vt.vs - values) ** 2)
        entropy = torch.mean(categorical_entropy(logits))
        total = (
            pg_loss + self.vf_loss_coeff * vf_loss - self.entropy_coeff * entropy
        )
        aux = {
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": torch.mean(
                torch.exp(target_logp - mb["behavior_logp"])
            ),
        }
        return total, aux


class LearnerGroup:
    """Runs a learner in-process or as one remote actor (module
    docstring).

    Parity: rllib/core/learner/learner_group.py:61.
    """

    def __init__(self, learner_cls, learner_kwargs: Dict[str, Any], mode: str = "local",
                 remote_options: Optional[Dict[str, Any]] = None):
        self.mode = mode
        if mode == "local":
            self._learner = learner_cls(**learner_kwargs)
            self._actor = None
        elif mode == "remote":
            import ray_tpu_torch

            options = dict(remote_options or {"num_cpus": 1})
            device = torch.device(learner_kwargs.get("device", "cuda"))
            if device.type == "cuda":
                options.setdefault("num_gpus", 1)
            actor_cls = ray_tpu_torch.remote(**options)(learner_cls)
            self._actor = actor_cls.remote(**learner_kwargs)
            self._learner = None
        else:
            raise ValueError(f"unknown LearnerGroup mode {mode!r}")

    def _call(self, method: str, *args):
        if self._learner is not None:
            return getattr(self._learner, method)(*args)
        import ray_tpu_torch

        return ray_tpu_torch.get(getattr(self._actor, method).remote(*args))

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self._call("update", batch)

    def get_weights(self):
        return self._call("get_weights")

    def get_state(self):
        return self._call("get_state")

    def set_state(self, state):
        self._call("set_state", state)

    def shutdown(self) -> None:
        """Kill the remote learner actor (it holds the card's lease —
        leaking it would keep the card leased for the next trial)."""
        if self._actor is not None:
            import ray_tpu_torch

            try:
                ray_tpu_torch.kill(self._actor)
            except Exception:  # noqa: BLE001 - already dead / shutdown race
                pass
            self._actor = None

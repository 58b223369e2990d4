"""Port vs JAX on the CPU: the RL learners (ray_tpu_torch.rllib.learner
against ray_tpu.rllib.learner), on the reference's initial weights carried
across and on seeded numpy batches.

- PPO's and IMPALA's loss_fn, their aux metrics and every gradient against
  jax.value_and_grad of the reference learner's loss_fn: f32, 1e-5. The
  batches put importance ratios on both sides of PPO's clip and IMPALA's
  rho clip, and some value errors past PPO's value clip.
- A whole update() at minibatch_size == train_batch_size, where each
  step's loss is a mean over the whole batch so the permutation changes
  only the order of the sums: PPO over 2 epochs (2 Adam steps), IMPALA one
  step. Parameters within 1e-5 absolute; metrics within 1e-5 relative.
- The update loop: the reference's minibatch arithmetic, and one read of
  the device per update however many minibatch steps it runs.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import learner as jlearner
from ray_tpu.rllib import models as jmodels
from ray_tpu_torch.rllib import learner as tlearner
from ray_tpu_torch.models.common import params_from_jax
from ray_tpu_torch.rllib.models import tree_leaves
from ray_tpu_torch.rllib.sample_batch import SampleBatch

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
OBS_DIM, NUM_ACTIONS, HIDDENS = 4, 2, (64, 64)


def ref_logp(params, obs, actions):
    logits, _ = jmodels.mlp_actor_critic_apply(params, obs)
    return np.asarray(jmodels.categorical_logp(logits, actions))


def ppo_batch(params, n=256, seed=0):
    """logp_old the reference policy's, moved by noise so the ratios reach
    past 1 ± 0.2 both ways; value targets wide enough that some squared
    errors pass the value clip (10² = 100)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, OBS_DIM)).astype(np.float32)
    actions = rng.integers(0, NUM_ACTIONS, n)
    logp = ref_logp(params, obs, actions) + rng.normal(0, 0.3, n)
    return SampleBatch({
        SampleBatch.OBS: obs,
        SampleBatch.ACTIONS: actions,
        SampleBatch.ACTION_LOGP: logp.astype(np.float32),
        SampleBatch.VF_PREDS: rng.normal(0, 1, n).astype(np.float32),
        SampleBatch.ADVANTAGES: rng.normal(0.3, 2, n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.normal(0, 8, n).astype(np.float32),
    })


def impala_batch(params, T=32, N=8, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, N, OBS_DIM)).astype(np.float32)
    actions = rng.integers(0, NUM_ACTIONS, (T, N))
    logp = ref_logp(params, obs.reshape(T * N, OBS_DIM), actions.reshape(-1))
    term = rng.random((T, N)) < 0.05
    return SampleBatch({
        SampleBatch.OBS: obs,
        SampleBatch.ACTIONS: actions,
        SampleBatch.REWARDS: rng.normal(1, 1, (T, N)).astype(np.float32),
        SampleBatch.TERMINATEDS: term,
        SampleBatch.TRUNCATEDS: (rng.random((T, N)) < 0.05) & ~term,
        SampleBatch.ACTION_LOGP: (logp.reshape(T, N)
                                  + rng.normal(0, 0.3, (T, N))).astype(np.float32),
        "_bootstrap_obs": rng.standard_normal((N, OBS_DIM)).astype(np.float32),
    })


ALGOS = {
    "ppo": (jlearner.PPOLearner, tlearner.PPOLearner, ppo_batch,
            dict(num_epochs=2, minibatch_size=256)),
    "impala": (jlearner.IMPALALearner, tlearner.IMPALALearner, impala_batch,
               dict(lr=5e-4)),
}


def pair(algo):
    """The reference learner and the port's on the CPU, the port holding the
    reference's initial weights."""
    jcls, tcls, make_batch, kw = ALGOS[algo]
    ref = jcls(obs_dim=OBS_DIM, num_actions=NUM_ACTIONS, hiddens=HIDDENS, seed=0, **kw)
    port = tcls(obs_dim=OBS_DIM, num_actions=NUM_ACTIONS, hiddens=HIDDENS, seed=0,
                device="cpu", **kw)
    port.set_weights(ref.get_weights())
    return ref, port, make_batch(ref.get_weights())


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_loss_and_every_gradient_match_jax(algo):
    ref, port, batch = pair(algo)
    jparams = ref.get_weights()
    if algo == "ppo":
        ratio = np.exp(ref_logp(jparams, batch["obs"], batch["actions"])
                       - batch["action_logp"])
        assert (ratio < 0.8).any() and (ratio > 1.2).any()
    (jloss, jaux), jgrads = jax.value_and_grad(ref.loss_fn, has_aux=True)(
        jparams, ref._prepare_batch(batch))
    tparams = params_from_jax(jparams, "cpu")
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tloss, taux = port.loss_fn(tparams, port._prepare_batch(batch))
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **LOSS_TOL, err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for i, (g, want) in enumerate(zip(tgrads, jleaves)):
        assert g.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **LOSS_TOL,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_whole_update_matches_jax(algo):
    ref, port, batch = pair(algo)
    want, got = ref.update(batch), port.update(batch)
    assert set(got) == set(want)
    assert got["num_env_steps_trained"] == want["num_env_steps_trained"] == 256
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **METRIC_TOL, err_msg=k)
    for g, w in zip(tree_leaves(port.get_weights()),
                    jax.tree_util.tree_leaves(ref.get_weights())):
        np.testing.assert_allclose(g, np.asarray(w), **PARAM_TOL)
    assert port._optimizer.count == int(ref.get_state()["step"])


def test_minibatch_arithmetic_and_one_device_read(monkeypatch):
    """n 200 at minibatch 64: 3 minibatches of 64 an epoch (8 rows
    dropped), each epoch a fresh permutation; the update reads the device
    once, at its end."""
    ref, port, batch = pair("ppo")
    port.minibatch_size, port.num_epochs = 64, 3
    batch = batch.slice(0, 200)
    seen = []
    step = port._sgd_step
    monkeypatch.setattr(port, "_sgd_step", lambda mb: seen.append(mb["obs"]) or step(mb))
    reads = []
    for name in ("item", "tolist", "numpy", "__float__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    metrics = port.update(batch)
    monkeypatch.undo()
    assert reads == ["tolist"]
    assert len(seen) == 9 and all(x.shape == (64, OBS_DIM) for x in seen)
    assert metrics["num_env_steps_trained"] == 200
    obs = torch.from_numpy(batch["obs"])
    rows = [torch.cat(seen[e * 3:(e + 1) * 3]) for e in range(3)]
    for r in rows:  # 192 distinct rows of the batch
        match = (r[:, None, :] == obs[None]).all(-1)
        assert (match.sum(1) == 1).all() and match.any(0).sum() == 192
    assert not torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_state_round_trip_gives_an_identical_next_update(algo):
    _, port, batch = pair(algo)
    port.update(batch)
    state = port.get_state()
    assert isinstance(state["params"]["pi"][0]["w"], np.ndarray)
    assert state["opt_state"]["count"] == state["step"] == port._step > 0
    other = ALGOS[algo][1](obs_dim=OBS_DIM, num_actions=NUM_ACTIONS,
                           hiddens=HIDDENS, seed=7, device="cpu",
                           **ALGOS[algo][3])
    other.set_state(state)
    a, b = port.update(batch), other.update(batch)
    assert a == b
    for x, y in zip(tree_leaves(port.get_state()), tree_leaves(other.get_state())):
        assert np.array_equal(x, y)


def test_state_holds_nothing_of_the_device():
    """Where the permutations have got to is two integers, not a
    generator's state (whose format differs between a CPU and a CUDA
    generator), so a state restores on another device type."""
    _, port, batch = pair("ppo")
    port.update(batch)
    state = port.get_state()
    assert state["perm"] == {"seed": 1, "draws": port.num_epochs}
    assert all(isinstance(x, (np.ndarray, int)) for x in tree_leaves(state))
    a, b, c = (tlearner.PPOLearner(obs_dim=OBS_DIM, num_actions=NUM_ACTIONS,
                                   hiddens=HIDDENS, seed=s, device="cpu")
               for s in (0, 0, 1))
    # the k-th permutation depends on the seed and k only
    perms = [[x._permutation(256) for _ in range(3)] for x in (a, b, c)]
    assert all(torch.equal(p, q) for p, q in zip(perms[0], perms[1]))
    assert not any(torch.equal(p, q) for p, q in zip(perms[0], perms[2]))
    assert not any(torch.equal(perms[0][i], perms[0][j])
                   for i, j in ((0, 1), (0, 2), (1, 2)))


def test_weights_are_host_copies():
    """get_weights hands out numpy copies: a later update does not reach
    them (on the CPU the tensors could otherwise share their memory)."""
    _, port, batch = pair("ppo")
    w = port.get_weights()
    before = w["pi"][0]["w"].copy()
    port.update(batch)
    assert np.array_equal(w["pi"][0]["w"], before)
    assert not np.array_equal(port.get_weights()["pi"][0]["w"], before)


def test_learner_group_runs_local():
    kw = dict(obs_dim=OBS_DIM, num_actions=NUM_ACTIONS, device="cpu")
    group = tlearner.LearnerGroup(tlearner.PPOLearner, kw)
    assert group.get_weights()["vf"][-1]["w"].shape == (64, 1)
    with pytest.raises(ValueError, match="unknown LearnerGroup mode"):
        tlearner.LearnerGroup(tlearner.PPOLearner, kw, mode="elsewhere")

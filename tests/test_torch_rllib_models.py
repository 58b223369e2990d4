"""Port vs JAX on the CPU: the RL stack's networks, v-trace, the envs and GAE
(ray_tpu_torch.rllib against ray_tpu.rllib, on the same seeded numpy
inputs).

- mlp_actor_critic_apply, categorical_logp and categorical_entropy on the
  reference's weights carried across by models/common.py's
  params_from_jax: f32, 1e-6.
- vtrace_from_logps, T 32, N 8, random dones, rhos on both sides of both
  clips: f32, 1e-5 (the same recursion in the same order; exp and the
  products round alike to a few ulps).
- The envs are numpy copies: the same seed and actions give identical
  observations, rewards and flags; compute_gae_lanes is bitwise the
  reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import postprocessing as jpost
from ray_tpu.rllib import vtrace as jvtrace
from ray_tpu.rllib.env import multi_agent as jma
from ray_tpu.rllib.env import vector_env as jvec
from ray_tpu_torch.models.common import params_from_jax
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib import postprocessing as tpost
from ray_tpu_torch.rllib import vtrace as tvtrace
from ray_tpu_torch.rllib.env import multi_agent as tma
from ray_tpu_torch.rllib.env import vector_env as tvec

MODEL_TOL = dict(rtol=1e-6, atol=1e-6)
VTRACE_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_params(obs_dim, num_actions, hiddens, seed=0):
    return jax.device_get(jmodels.mlp_actor_critic_init(
        jax.random.PRNGKey(seed), obs_dim, num_actions, hiddens))


@pytest.mark.parametrize("obs_dim,num_actions,hiddens", [
    (4, 2, (64, 64)), (8, 3, (32,)),
])
def test_actor_critic_and_distribution_match_jax(obs_dim, num_actions, hiddens):
    jp = jax_params(obs_dim, num_actions, hiddens)
    tp = params_from_jax(jp, "cpu")
    assert tmodels.tree_map(lambda t: (t.shape, t.dtype), tp) == \
        tmodels.tree_map(lambda a: (torch.Size(a.shape), torch.float32), jp)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((64, obs_dim)).astype(np.float32)
    actions = rng.integers(0, num_actions, 64)
    jl, jv = jmodels.mlp_actor_critic_apply(jp, jnp.asarray(obs))
    tl, tv = tmodels.mlp_actor_critic_apply(tp, torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODEL_TOL)
    # the logits scaled up, so the distribution is far from uniform
    jl, tl = jl * 30, tl * 30
    np.testing.assert_allclose(
        tmodels.categorical_logp(tl, torch.from_numpy(actions)).numpy(),
        np.asarray(jmodels.categorical_logp(jl, jnp.asarray(actions))), **MODEL_TOL)
    np.testing.assert_allclose(
        tmodels.categorical_entropy(tl).numpy(),
        np.asarray(jmodels.categorical_entropy(jl)), **MODEL_TOL)


def test_init_and_sample_follow_the_generator():
    """init: the reference's shapes, scales and zero biases, drawn from the
    generator (the same seed, the same weights); categorical_sample: the
    empirical distribution of Gumbel-max draws is the softmax."""
    def init(seed):
        return tmodels.mlp_actor_critic_init(
            torch.Generator().manual_seed(seed), 4, 2, (64, 64), "cpu")

    a, b, c = init(0), init(0), init(1)
    leaves = tmodels.tree_leaves
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["pi"][0]["w"], c["pi"][0]["w"])
    ref = jax_params(4, 2, (64, 64))
    assert tmodels.tree_map(lambda t: tuple(t.shape), a) == \
        tmodels.tree_map(lambda x: tuple(x.shape), ref)
    assert all(not x.any() for layer in a["pi"] + a["vf"] for x in [layer["b"]])
    assert a["pi"][0]["w"].std().item() == pytest.approx(np.sqrt(2 / 4), rel=0.15)
    assert a["pi"][-1]["w"].std().item() == pytest.approx(0.01, rel=0.3)

    logits = torch.tensor([[0.0, 1.0, -1.0]]).repeat(20_000, 1)
    draws = tmodels.categorical_sample(torch.Generator().manual_seed(0), logits)
    freq = torch.bincount(draws, minlength=3).double() / len(draws)
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0].double(), 0).numpy(),
                               atol=0.01)


def vtrace_inputs(seed=0, T=32, N=8):
    """Behavior and target logps whose ratios fall on both sides of each
    clip (rho clip 1.0, c clip 0.9, pg clip 1.3)."""
    rng = np.random.default_rng(seed)
    behavior = rng.normal(-1.0, 0.4, (T, N)).astype(np.float32)
    target = (behavior + rng.normal(0, 0.5, (T, N))).astype(np.float32)
    rewards = rng.normal(0, 1, (T, N)).astype(np.float32)
    values = rng.normal(0, 1, (T, N)).astype(np.float32)
    bootstrap = rng.normal(0, 1, N).astype(np.float32)
    done = rng.random((T, N)) < 0.1
    discounts = (0.99 * (1 - done)).astype(np.float32)
    return behavior, target, rewards, values, bootstrap, discounts


@pytest.mark.parametrize("clips", [(1.0, 1.0, None), (1.0, 0.9, 1.3)])
def test_vtrace_matches_jax(clips):
    args = vtrace_inputs()
    rhos = np.exp(args[1] - args[0])
    assert (rhos < 0.9).any() and (rhos > 1.3).any()
    kw = dict(clip_rho_threshold=clips[0], clip_c_threshold=clips[1],
              clip_pg_rho_threshold=clips[2])
    want = jvtrace.vtrace_from_logps(*(jnp.asarray(a) for a in args), **kw)
    tensors = [torch.from_numpy(a) for a in args]
    tensors[1].requires_grad_(True)
    tensors[3].requires_grad_(True)
    got = tvtrace.vtrace_from_logps(*tensors, **kw)
    assert not got.vs.requires_grad and not got.pg_advantages.requires_grad
    np.testing.assert_allclose(got.vs.numpy(), np.asarray(want.vs), **VTRACE_TOL)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               np.asarray(want.pg_advantages), **VTRACE_TOL)


def test_gae_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    T, N = 64, 8
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    boot = rng.normal(size=N).astype(np.float32)
    term = rng.random((T, N)) < 0.05
    trunc = (rng.random((T, N)) < 0.05) & ~term
    for kw in ({}, {"gamma": 0.9, "lambda_": 0.8}):
        got = tpost.compute_gae_lanes(rewards, values, boot, term, trunc, **kw)
        want = jpost.compute_gae_lanes(rewards, values, boot, term, trunc, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name,steps", [("CartPole-v1", 700), ("Pong-v0", 3000)])
def test_vector_env_copies_step_identically(name, steps):
    """The same reset seed and actions: identical observations, rewards and
    flags, auto-resets included (CartPole's episodes end early under random
    actions and one lane is held balanced to its 500-step truncation)."""
    tenv, jenv = tvec.make_vector_env(name, 4), jvec.make_vector_env(name, 4)
    assert (tenv.obs_dim, tenv.num_actions, tenv.max_episode_steps) == \
        (jenv.obs_dim, jenv.num_actions, jenv.max_episode_steps)
    obs = tenv.reset(seed=11)
    assert np.array_equal(obs, jenv.reset(seed=11))
    rng = np.random.default_rng(0)
    ended = {"term": 0, "trunc": 0}
    for _ in range(steps):
        actions = rng.integers(0, tenv.num_actions, 4)
        if name == "CartPole-v1":  # lane 0 balances: push toward the lean
            actions[0] = int(obs[0, 2] + 0.5 * obs[0, 3] > 0)
        got, want = tenv.step(actions), jenv.step(actions)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        obs = got[0]
        ended["term"] += int(got[2].sum())
        ended["trunc"] += int(got[3].sum())
    assert ended["term"] > 0
    if name == "CartPole-v1":
        assert ended["trunc"] > 0


def test_multi_agent_env_copy_steps_identically():
    tenv = tma.make_multi_agent_env("MultiAgentCartPole", 4, num_agents=3)
    jenv = jma.make_multi_agent_env("MultiAgentCartPole", 4, num_agents=3)
    assert tenv.agent_ids == jenv.agent_ids
    got, want = tenv.reset(seed=5), jenv.reset(seed=5)
    assert all(np.array_equal(got[a], want[a]) for a in want)
    rng = np.random.default_rng(1)
    for _ in range(200):
        actions = {a: rng.integers(0, 2, 4) for a in tenv.agent_ids}
        for g, w in zip(tenv.step(actions), jenv.step(actions)):
            assert all(np.array_equal(g[a], w[a]) for a in w)


def test_register_env(monkeypatch):
    monkeypatch.setattr(tvec, "_BUILTIN", dict(tvec._BUILTIN))
    tvec.register_env("my-cartpole", tvec._BUILTIN["CartPole-v1"])
    assert tvec.make_vector_env("my-cartpole", 3).num_envs == 3


def test_sample_batch_copy_matches_the_reference():
    """The same columns through slice, take, shuffle, minibatches,
    concat_samples and split_by_episode give the reference's arrays, the
    "_" metadata carried as the reference carries it; as_torch gives the
    columns as CPU tensors of the same values."""
    from ray_tpu.rllib.sample_batch import SampleBatch as JBatch
    from ray_tpu_torch.rllib.sample_batch import SampleBatch as TBatch

    rng = np.random.default_rng(0)
    cols = {"obs": rng.standard_normal((12, 3)).astype(np.float32),
            "eps_id": np.repeat([4, 7, 9], 4), "_bootstrap_obs": np.ones((2, 3))}
    t, j = TBatch(cols), JBatch(cols)

    def same(a, b):
        assert set(a) == set(b) and len(a) == len(b)
        assert all(np.array_equal(a[k], b[k]) for k in b)

    same(t.slice(2, 9), j.slice(2, 9))
    same(t.take(np.array([5, 0, 3])), j.take(np.array([5, 0, 3])))
    same(t.shuffle(np.random.default_rng(1)), j.shuffle(np.random.default_rng(1)))
    for a, b in zip(t.minibatches(5), j.minibatches(5), strict=True):
        same(a, b)
    same(TBatch.concat_samples([t, t.slice(0, 2)]), JBatch.concat_samples([j, j.slice(0, 2)]))
    for a, b in zip(t.split_by_episode(), j.split_by_episode(), strict=True):
        same(a, b)
    with pytest.raises(ValueError, match="ragged"):
        TBatch({"a": np.zeros(2), "b": np.zeros(3)})
    tensors = t.as_torch("cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in tensors.values())
    assert all(np.array_equal(tensors[k].numpy(), t[k]) for k in t)

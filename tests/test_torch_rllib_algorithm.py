"""Port vs JAX on the CPU: the rollout runners and the algorithms
(ray_tpu_torch.rllib against ray_tpu.rllib) at small sizes: 4 envs,
fragments of 32 to 64 steps, train batch 256, minibatch 64, the learner
on device="cpu".

- EnvRunner on the reference's weights carried across: its ACTION_LOGP
  and VF_PREDS are the reference model's on the runner's recorded obs and
  actions (f32, 1e-6); its GAE columns are the reference's
  compute_gae_lanes on its own buffers, bitwise; replaying its actions in
  the reference's env gives its obs, rewards and flags, bitwise, for the
  "gae", "vtrace" and "transitions" batches, whose columns are the
  reference runner's.
- PPO, multi-agent PPO, IMPALA, DQN, SAC and BC build().train() return
  the reference's result keys; save() then restore() into a fresh
  algorithm gives identical weights and an identical next update (DQN's
  and SAC's replay buffer and env-step count are not in the checkpoint,
  as in the reference); the remote topologies raise NotImplementedError
  naming ROADMAP.md Queue A item 5; the learner defaults to the card.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import postprocessing as jpost
from ray_tpu.rllib.algorithms import BCConfig as JBCConfig
from ray_tpu.rllib.algorithms import DQNConfig as JDQNConfig
from ray_tpu.rllib.algorithms import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.algorithms import PPOConfig as JPPOConfig
from ray_tpu.rllib.algorithms import SACConfig as JSACConfig
from ray_tpu.rllib.env import vector_env as jvec
from ray_tpu.rllib.env_runner import EnvRunner as JEnvRunner
from ray_tpu.rllib.multi_agent_runner import MultiAgentEnvRunner as JMARunner
from ray_tpu_torch.rllib.algorithms import (
    BCConfig, DQNConfig, IMPALAConfig, PPOConfig, SACConfig,
)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.models import tree_leaves
from ray_tpu_torch.rllib.multi_agent_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.offline import JsonWriter

MODEL_TOL = dict(rtol=1e-6, atol=1e-6)
T, N = 48, 4


def ref_params(env="CartPole-v1", seed=3):
    probe = jvec.make_vector_env(env, 1)
    return jax.device_get(jmodels.mlp_actor_critic_init(
        jax.random.PRNGKey(seed), probe.obs_dim, probe.num_actions, (64, 64)))


def replay(env, seed, actions):
    """The reference's env from `seed`, stepped with `actions` [T, N] → its
    obs before each step and after the last, rewards, flags."""
    jenv = jvec.make_vector_env(env, actions.shape[1])
    obs = [jenv.reset(seed=seed)]
    rew, term, trunc = [], [], []
    for a in actions:
        o, r, te, tr = jenv.step(a)
        obs.append(o), rew.append(r), term.append(te), trunc.append(tr)
    return np.stack(obs), np.stack(rew), np.stack(term), np.stack(trunc)


@pytest.mark.parametrize("env", ["CartPole-v1", "Pong-v0"])
@pytest.mark.parametrize("postprocess", ["gae", "vtrace", "transitions"])
def test_env_runner_columns_match_the_reference(env, postprocess):
    params = ref_params(env)
    runner = EnvRunner(env, num_envs=N, seed=2, worker_index=1,
                       postprocess=postprocess)
    batch, metrics = runner.sample(T, params)
    want_batch, want_metrics = JEnvRunner(
        env, num_envs=N, seed=2, worker_index=1, postprocess=postprocess,
    ).sample(T, params)
    assert set(batch) == set(want_batch)
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} == \
        {k: (v.shape, v.dtype) for k, v in want_batch.items()}
    assert set(metrics) == set(want_metrics)
    assert metrics["num_env_steps"] == T * N

    def lanes(x):  # [T * N, ...] rows or [T, N, ...] → [T, N, ...]
        return x.reshape((T, N) + x.shape[(1 if postprocess == "vtrace" else 0) + 1:])

    actions = lanes(batch["actions"])
    obs, rew, term, trunc = replay(env, 2 * 997 + 1, actions)
    assert np.array_equal(lanes(batch["obs"]), obs[:-1])
    for key, want in (("rewards", rew), ("terminateds", term), ("truncateds", trunc)):
        assert np.array_equal(lanes(batch[key]), want), key
    if postprocess == "transitions":
        assert np.array_equal(lanes(batch["next_obs"]), obs[1:])
        return
    if postprocess == "vtrace":
        assert np.array_equal(batch["_bootstrap_obs"], obs[-1])
    logits, values = jmodels.mlp_actor_critic_apply(params, obs[:-1].reshape(T * N, -1))
    logp = jmodels.categorical_logp(logits, actions.reshape(-1))
    np.testing.assert_allclose(batch["action_logp"].reshape(-1), np.asarray(logp),
                               **MODEL_TOL)
    if postprocess == "vtrace":
        return
    np.testing.assert_allclose(batch["vf_preds"], np.asarray(values), **MODEL_TOL)
    adv, targets = jpost.compute_gae_lanes(
        lanes(batch["rewards"]), lanes(batch["vf_preds"]), runner._value(obs[-1]),
        lanes(batch["terminateds"]), lanes(batch["truncateds"]))
    assert np.array_equal(lanes(batch["advantages"]), adv)
    assert np.array_equal(lanes(batch["value_targets"]), targets)


def test_runner_keeps_its_policy_on_the_cpu_and_seeds_as_the_reference():
    runner = EnvRunner("CartPole-v1", num_envs=N, seed=5, worker_index=2)
    assert all(t.device.type == "cpu" for t in tree_leaves(runner.params))
    again = EnvRunner("CartPole-v1", num_envs=N, seed=5, worker_index=2)
    assert np.array_equal(runner._obs, jvec.make_vector_env("CartPole-v1", N)
                          .reset(seed=5 * 997 + 2))
    a, b = runner.sample(16)[0], again.sample(16)[0]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    eps = EnvRunner("CartPole-v1", num_envs=64, act_mode="epsilon_greedy")
    batch, _ = eps.sample(4, epsilon=0.0)
    q, _ = jmodels.mlp_actor_critic_apply(
        jax.device_get(eps.get_weights()), batch["obs"])
    assert np.array_equal(batch["actions"], np.argmax(np.asarray(q), -1))
    batch, _ = eps.sample(64, epsilon=1.0)
    assert 0.4 < batch["actions"].mean() < 0.6


def test_multi_agent_runner_matches_the_reference_layout():
    kw = dict(policy_mapping={"agent_0": "left", "agent_1": "left",
                              "agent_2": "right"},
              num_envs=N, hiddens=(16,), seed=0, env_kwargs={"num_agents": 3})
    runner = MultiAgentEnvRunner("MultiAgentCartPole", **kw)
    weights = jax.device_get(JMARunner("MultiAgentCartPole", **kw).get_weights())
    batches, metrics = runner.sample(16, weights)
    want, want_metrics = JMARunner("MultiAgentCartPole", **kw).sample(16, weights)
    assert sorted(batches) == sorted(want) == ["left", "right"]
    for pid in want:
        assert {k: (v.shape, v.dtype) for k, v in batches[pid].items()} == \
            {k: (v.shape, v.dtype) for k, v in want[pid].items()}
    assert set(metrics) == set(want_metrics)
    assert metrics["num_env_steps"] == 16 * N
    assert metrics["num_agent_steps"] == 16 * N * 3
    b = batches["right"]
    logits, values = jmodels.mlp_actor_critic_apply(weights["right"], b["obs"])
    np.testing.assert_allclose(
        b["action_logp"], np.asarray(jmodels.categorical_logp(logits, b["actions"])),
        **MODEL_TOL)
    np.testing.assert_allclose(b["vf_preds"], np.asarray(values), **MODEL_TOL)


def ppo(config_cls, **resources):
    return (config_cls()
            .environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(rollout_fragment_length=64)
            .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
            .resources(**resources)
            .debugging(seed=0))


def ma_ppo(config_cls, **resources):
    return (config_cls()
            .environment("MultiAgentCartPole", num_envs_per_worker=N,
                         env_kwargs={"num_agents": 2})
            .rollouts(rollout_fragment_length=32)
            .multi_agent(policies=["p0", "p1"],
                         policy_mapping_fn=lambda aid: "p" + aid[-1])
            .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
            .resources(**resources)
            .debugging(seed=0))


def impala(config_cls, **resources):
    return (config_cls()
            .environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(rollout_fragment_length=32)
            .training(updates_per_iteration=2)
            .resources(**resources)
            .debugging(seed=0))


@pytest.mark.parametrize("make", [ppo, ma_ppo, impala])
def test_train_returns_the_reference_result_keys(make):
    algo = make(PPOConfig if make is not impala else IMPALAConfig,
                learner_device="cpu").build()
    ref = make(JPPOConfig if make is not impala else JIMPALAConfig).build()
    got, want = algo.train(), ref.train()
    assert set(got) == set(want)
    assert got["timesteps_this_iter"] == want["timesteps_this_iter"]
    if make is ma_ppo:
        assert set(got["per_agent_reward_mean"]) == {"agent_0", "agent_1"}
        # the reference's key, None there too (the learner says total_loss)
        assert got["policy/p0/loss"] is want["policy/p0/loss"] is None
        assert set(algo.get_weights()) == {"p0", "p1"}
    algo.stop()


@pytest.mark.parametrize("make", [ppo, ma_ppo])
def test_save_restore_gives_identical_weights_and_next_update(make, tmp_path):
    algo = make(PPOConfig, learner_device="cpu").build()
    algo.train()
    ckpt = algo.save(str(tmp_path / "ck"))
    fresh = make(PPOConfig, learner_device="cpu").debugging(seed=1).build()
    fresh.restore(ckpt)
    assert fresh.iteration == 1
    w, w2 = algo.get_weights(), fresh.get_weights()
    assert all(np.array_equal(a, b) for a, b in zip(tree_leaves(w), tree_leaves(w2)))
    if make is ppo:
        groups = [(algo.learner_group, fresh.learner_group)]
        batch = algo.sample_batch()
    else:
        groups = list(zip(algo.learner_groups.values(), fresh.learner_groups.values()))
        batch = algo.local_runner.sample(64)[0]["p0"]
    for a, b in groups:
        assert a.update(batch) == b.update(batch)
        assert all(np.array_equal(x, y) for x, y in zip(
            tree_leaves(a.get_weights()), tree_leaves(b.get_weights())))


@pytest.mark.parametrize("change,match", [
    (lambda c: c.rollouts(num_rollout_workers=2), "EnvRunner actors"),
    (lambda c: c.resources(learner_mode="remote"), "learner_mode='remote'"),
])
@pytest.mark.parametrize("make", [ppo, ma_ppo])
def test_remote_topologies_are_refused(make, change, match):
    with pytest.raises(NotImplementedError, match=f"{match}.*Queue A item 5"):
        change(make(PPOConfig, learner_device="cpu")).build()


def test_impala_with_workers_is_refused():
    with pytest.raises(NotImplementedError,
                       match="IMPALA.*asynchronous training_step.*Queue A item 5"):
        impala(IMPALAConfig, learner_device="cpu").rollouts(
            num_rollout_workers=2).build()


def test_learner_defaults_to_the_card():
    """The config's learner device is "cuda" unless the caller says
    otherwise; without a card, building it raises (nothing carries on on
    the CPU)."""
    cfg = ppo(PPOConfig)
    assert cfg.learner_device == "cuda"
    if torch.cuda.is_available():
        algo = cfg.build()
        assert algo.learner_group._learner.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cfg.build()


# -- DQN, SAC, BC ------------------------------------------------------------ #
# Small sizes: 4 envs, fragments of 32 (128 rows an iteration, long enough
# for a random CartPole policy to end episodes), learning from the first
# iteration on, so one train() runs the updates.

def dqn(config_cls, **resources):
    return (config_cls()
            .environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(rollout_fragment_length=32)
            .training(train_batch_size=32, learning_starts=32, train_intensity=2,
                      target_update_freq=3)
            .resources(**resources)
            .debugging(seed=0))


def sac(config_cls, **resources):
    return (config_cls()
            .environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(rollout_fragment_length=32)
            .training(train_batch_size=32, learning_starts=32, train_intensity=2)
            .resources(**resources)
            .debugging(seed=0))


@pytest.fixture(scope="module")
def expert_path(tmp_path_factory):
    """Logged CartPole experience: two fragments of a random policy."""
    path = tmp_path_factory.mktemp("bc")
    w = JsonWriter(str(path))
    runner = EnvRunner("CartPole-v1", num_envs=N, seed=1)
    for _ in range(2):
        batch, _ = runner.sample(16)
        w.write({k: batch[k] for k in ("obs", "actions", "rewards")})
    w.close()
    return str(path)


def bc(config_cls, path, **resources):
    return (config_cls()
            .offline_data(path)
            .environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(rollout_fragment_length=16)
            .training(train_batch_size=32, train_intensity=2)
            .resources(**resources)
            .debugging(seed=0))


OFF_POLICY = {"dqn": (dqn, DQNConfig, JDQNConfig), "sac": (sac, SACConfig, JSACConfig)}


@pytest.mark.parametrize("algo", ["dqn", "sac", "bc"])
def test_offpolicy_and_offline_train_returns_the_reference_result_keys(algo, expert_path):
    if algo == "bc":
        got_algo = bc(BCConfig, expert_path, learner_device="cpu").build()
        ref = bc(JBCConfig, expert_path).build()
    else:
        make, cfg, jcfg = OFF_POLICY[algo]
        got_algo, ref = make(cfg, learner_device="cpu").build(), make(jcfg).build()
    got, want = got_algo.train(), ref.train()
    assert set(got) == set(want)
    assert "loss" in got
    if algo == "bc":
        assert got["dataset_size"] == want["dataset_size"] == 2 * 16 * N
    else:
        assert got["timesteps_this_iter"] == want["timesteps_this_iter"] == 128
        assert got["buffer_size"] == want["buffer_size"] == 128
        assert got["num_updates"] == want["num_updates"] == 2
    if algo == "dqn":
        assert got["epsilon"] == want["epsilon"] == 1.0
        assert 0.0 < got_algo._epsilon() < 1.0
    got_algo.stop()


@pytest.mark.parametrize("algo", ["dqn", "sac", "bc"])
def test_offpolicy_save_restore_gives_identical_weights_and_next_update(algo, expert_path,
                                                                     tmp_path):
    def build(seed):
        if algo == "bc":
            return bc(BCConfig, expert_path, learner_device="cpu").debugging(
                seed=seed).build()
        make, cfg, _ = OFF_POLICY[algo]
        return make(cfg, learner_device="cpu").debugging(seed=seed).build()
    trained = build(0)
    for _ in range(2):
        trained.train()
    ckpt = trained.save(str(tmp_path / "ck"))
    fresh = build(1)
    fresh.restore(ckpt)
    assert fresh.iteration == 2
    assert all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(trained.get_weights()), tree_leaves(fresh.get_weights())))
    a, b = trained.learner_group, fresh.learner_group
    for x, y in zip(tree_leaves(a.get_state()), tree_leaves(b.get_state())):
        assert np.array_equal(x, y)
    batch = trained.buffer.sample(32)
    m, n = a.update(batch), b.update(batch)
    assert m.keys() == n.keys() and all(np.array_equal(m[k], n[k]) for k in m)
    assert all(np.array_equal(x, y) for x, y in zip(
        tree_leaves(a.get_state()), tree_leaves(b.get_state())))
    if algo != "bc":
        # the reference's checkpoint holds the learner only: the restored
        # algorithm refills its buffer and, for DQN, starts again at
        # epsilon_start (ROADMAP.md Queue C)
        assert len(fresh.buffer) == 0 and fresh._env_steps == 0
        assert len(trained.buffer) == 256
    if algo == "dqn":
        assert fresh._epsilon() == 1.0 > trained._epsilon()


@pytest.mark.parametrize("change,match", [
    (lambda c: c.rollouts(num_rollout_workers=2), "EnvRunner actors"),
    (lambda c: c.resources(learner_mode="remote"), "learner_mode='remote'"),
])
@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_offpolicy_remote_topologies_are_refused(algo, change, match):
    make, cfg, _ = OFF_POLICY[algo]
    with pytest.raises(NotImplementedError, match=f"{match}.*Queue A item 5"):
        change(make(cfg, learner_device="cpu")).build()


@pytest.mark.parametrize("algo", ["dqn", "sac", "bc"])
def test_offpolicy_learner_defaults_to_the_card(algo, expert_path):
    cfg = (bc(BCConfig, expert_path) if algo == "bc"
           else OFF_POLICY[algo][0](OFF_POLICY[algo][1]))
    assert cfg.learner_device == "cuda"
    if torch.cuda.is_available():
        algo = cfg.build()
        assert algo.learner_group._learner.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cfg.build()

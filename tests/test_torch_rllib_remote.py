"""Port vs reference: RLlib's remote topologies on the multi-process
runtime (ray_tpu_torch.rllib against ray_tpu.rllib), one ray_tpu and one
ray_tpu_torch cluster for the module (num_cpus=4 each: two EnvRunner
actors and a learner actor leave a CPU for this process's tasks). The
learner runs on device="cpu".

The runners draw their actions from torch generators where the
reference's draw from JAX keys, so a batch is held to the reference as
tests/test_torch_rllib_algorithm.py holds the inline runner's: the same
columns, shapes and dtypes as the reference's remote batch; its actions
replayed in the reference's env give its obs, rewards and flags bitwise;
its action_logp and vf_preds are the reference model's (1e-6). Each remote
batch is also equal, bitwise, to the port's inline runner of the same
worker index on the same weights.

- PPO with 2 remote runners: the first sampled batch as above; the first
  update, from the reference's weights, within the learner tests' parity
  tolerance (1e-5) of ray_tpu's on the same batch (minibatch = train
  batch, so the permutations change only the order of sums); train()
  gives the reference's result keys. Multi-agent PPO with 2 remote
  runners trains.
- A remote LearnerGroup's update equals the local learner's in every bit
  on the CPU (metrics and weights), for every learner; a learner on a card
  asks for a GPU lease.
- IMPALA with 2 workers runs 2 asynchronous iterations with the
  reference's result keys and step counts, one sample in flight a worker.
- DQN's and SAC's remote sampling: the first round's batches as above,
  then train() with the reference's result keys; DQN and BC with the
  learner remote.
- offline.to_dataset's rows equal the reference's.
- Nothing of the port's cluster is left after shutdown.
"""

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib.algorithms import DQNConfig as JDQNConfig
from ray_tpu.rllib.algorithms import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.algorithms import PPOConfig as JPPOConfig
from ray_tpu.rllib.algorithms import SACConfig as JSACConfig
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.rllib import learner as tlearner
from ray_tpu_torch.rllib.algorithms import (
    BCConfig, DQNConfig, IMPALAConfig, PPOConfig, SACConfig,
)
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.models import tree_leaves
from ray_tpu_torch.rllib.offline import JsonWriter
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from test_torch_rllib_algorithm import MODEL_TOL, replay
from test_torch_rllib_learner import impala_batch, ppo_batch
from test_torch_rllib_offpolicy import replay_batch
from torch_cluster_pairs import assert_nothing_left, port_identity

N, WORKERS = 4, 2
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def clusters():
    for ray in (ray_tpu, ray_tpu_torch):
        ray.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield port_identity()
    for ray in (ray_tpu, ray_tpu_torch):
        ray.shutdown()


def build(make, port_cls, ref_cls, **port_resources):
    """The port's algorithm (learner on the CPU) and the reference's."""
    return (make(port_cls).resources(learner_device="cpu", **port_resources)
            .build(), make(ref_cls).build())


def ppo(cls):
    return (cls().environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(num_rollout_workers=WORKERS, rollout_fragment_length=32)
            .training(train_batch_size=WORKERS * N * 32,
                      minibatch_size=WORKERS * N * 32, num_epochs=2)
            .debugging(seed=0))


def impala(cls):
    return (cls().environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(num_rollout_workers=WORKERS, rollout_fragment_length=32)
            .training(updates_per_iteration=2)
            .debugging(seed=0))


def dqn(cls):
    return (cls().environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(num_rollout_workers=WORKERS, rollout_fragment_length=16)
            .training(train_batch_size=32, learning_starts=32,
                      train_intensity=2, target_update_freq=3)
            .debugging(seed=0))


def sac(cls):
    return (cls().environment("CartPole-v1", num_envs_per_worker=N)
            .rollouts(num_rollout_workers=WORKERS, rollout_fragment_length=16)
            .training(train_batch_size=32, learning_starts=32, train_intensity=2)
            .debugging(seed=0))


def ref_round(algo, **sample_kwargs):
    """The reference's remote round: one fragment from each runner."""
    cfg = algo.algo_config
    return ray_tpu.get([w.sample.remote(cfg.rollout_fragment_length,
                                        algo._weights, **sample_kwargs)
                        for w in algo.workers], timeout=120)


def carry_weights(port, ref):
    """The reference's initial policy weights into the port's learner and
    its runners' next round."""
    port.learner_group._learner.set_weights(ref.get_weights())
    port._weights = port.learner_group.get_weights()


def check_round(port, outs, ref_outs, postprocess, runner_kwargs,
                **sample_kwargs):
    """A remote round's batches held to the reference's (module docstring)
    and to the port's inline runner of each worker index."""
    cfg = port.algo_config
    T = cfg.rollout_fragment_length
    assert len(outs) == len(ref_outs) == WORKERS
    for i, ((batch, metrics), (want, want_metrics)) in enumerate(
            zip(outs, ref_outs)):
        assert {k: (v.shape, v.dtype) for k, v in batch.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}
        assert set(metrics) == set(want_metrics)
        assert metrics["worker_index"] == i + 1
        inline = EnvRunner("CartPole-v1", num_envs=N, seed=cfg.seed,
                           worker_index=i + 1, hiddens=tuple(cfg.hiddens),
                           gamma=cfg.gamma, lambda_=cfg.lambda_,
                           postprocess=postprocess, **runner_kwargs)
        again, _ = inline.sample(T, port._weights, **sample_kwargs)
        assert all(np.array_equal(batch[k], again[k]) for k in again)

        def lanes(x):
            return x.reshape((T, N) + x.shape[1:])

        actions = lanes(batch["actions"])
        obs, rew, term, trunc = replay("CartPole-v1", cfg.seed * 997 + i + 1,
                                       actions)
        assert np.array_equal(lanes(batch["obs"]), obs[:-1])
        for key, val in (("rewards", rew), ("terminateds", term),
                         ("truncateds", trunc)):
            assert np.array_equal(lanes(batch[key]), val), key
        if postprocess == "transitions":
            assert np.array_equal(lanes(batch["next_obs"]), obs[1:])
            continue
        logits, values = jmodels.mlp_actor_critic_apply(
            jax.device_get(port._weights), batch["obs"])
        np.testing.assert_allclose(
            batch["action_logp"],
            np.asarray(jmodels.categorical_logp(logits, batch["actions"])),
            **MODEL_TOL)
        np.testing.assert_allclose(batch["vf_preds"], np.asarray(values),
                                   **MODEL_TOL)


def test_ppo_remote_runners_and_first_update_match_the_reference(clusters):
    port, ref = build(ppo, PPOConfig, JPPOConfig)
    try:
        carry_weights(port, ref)
        assert port.local_runner is None and len(port.workers) == WORKERS
        outs = port.sample_round(port._weights)
        check_round(port, outs, ref_round(ref), "gae", {})
        batch = SampleBatch.concat_samples([b for b, _ in outs])
        got = port.learner_group.update(batch)
        want = ref.learner_group.update(JSampleBatch(dict(batch)))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **METRIC_TOL, err_msg=k)
        got, want = port.train(), ref.train()
        assert set(got) == set(want)
        assert got["timesteps_this_iter"] == want["timesteps_this_iter"] \
            == WORKERS * N * 32
    finally:
        port.stop()
        ref.stop()


def test_multi_agent_ppo_with_remote_runners(clusters):
    def ma(cls, workers):
        return (cls().environment("MultiAgentCartPole", num_envs_per_worker=N,
                                  env_kwargs={"num_agents": 2})
                .rollouts(num_rollout_workers=workers, rollout_fragment_length=16)
                .multi_agent(policies=["p0", "p1"],
                             policy_mapping_fn=lambda aid: "p" + aid[-1])
                .training(train_batch_size=128, minibatch_size=64, num_epochs=1)
                .resources(learner_device="cpu").debugging(seed=0))

    remote, inline = ma(PPOConfig, WORKERS).build(), ma(PPOConfig, 0).build()
    try:
        got, want = remote.train(), inline.train()
        assert set(got) == set(want)
        assert got["timesteps_this_iter"] == want["timesteps_this_iter"] \
            == WORKERS * N * 16
        assert set(got["per_agent_reward_mean"]) <= {"agent_0", "agent_1"}
    finally:
        remote.stop()
        inline.stop()


# learner class, its kwargs, its number of actions (the batches' own), batch
LEARNERS = {
    "ppo": (tlearner.PPOLearner, dict(num_epochs=2, minibatch_size=64), 2,
            ppo_batch),
    "impala": (tlearner.IMPALALearner, dict(lr=5e-4), 2, impala_batch),
    "dqn": (tdqn.DQNLearner, dict(target_update_freq=2), 3,
            lambda w: replay_batch(0)),
    "sac": (tsac.SACLearner, dict(tau=0.05), 3, lambda w: replay_batch(1)),
    "bc": (tbc.BCLearner, dict(lr=1e-3), 3, lambda w: replay_batch(2)),
}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_a_remote_learner_group_matches_the_local_learner(clusters, name):
    cls, extra, actions, make_batch = LEARNERS[name]
    kw = dict(obs_dim=4, num_actions=actions, seed=0, device="cpu", **extra)
    local = tlearner.LearnerGroup(cls, kw)
    remote = tlearner.LearnerGroup(cls, kw, mode="remote")
    try:
        assert remote._learner is None and remote._actor is not None
        batch = make_batch(local.get_weights())
        for _ in range(2):
            got, want = remote.update(batch), local.update(batch)
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), k
        for a, b in zip(tree_leaves(remote.get_state()),
                        tree_leaves(local.get_state())):
            assert np.array_equal(a, b)
    finally:
        remote.shutdown()


def test_a_card_learner_asks_for_a_gpu_lease(monkeypatch):
    """The remote learner's options: a GPU lease of one card when its device
    is a card, none on the CPU; options that name num_gpus are kept."""
    asked = []

    def remote(**options):
        asked.append(options)

        class Handle:
            @staticmethod
            def remote(**kwargs):
                return object()
        return lambda cls: Handle

    monkeypatch.setattr(ray_tpu_torch, "remote", remote, raising=False)
    kw = dict(obs_dim=4, num_actions=2)
    for device, options in (("cuda", None), ("cuda:0", {"num_cpus": 2}),
                            ("cpu", None), ("cuda", {"num_gpus": 0.5})):
        tlearner.LearnerGroup(tlearner.PPOLearner, dict(kw, device=device),
                              mode="remote", remote_options=options)
    assert asked == [{"num_cpus": 1, "num_gpus": 1},
                     {"num_cpus": 2, "num_gpus": 1},
                     {"num_cpus": 1},
                     {"num_gpus": 0.5}]
    assert PPOConfig().learner_remote_options == {"num_cpus": 1}


def test_impala_asynchronous_iterations_match_the_reference(clusters):
    port, ref = build(impala, IMPALAConfig, JIMPALAConfig)
    try:
        for _ in range(2):
            got, want = port.train(), ref.train()
            assert set(got) == set(want)
            assert got["timesteps_this_iter"] == want["timesteps_this_iter"] \
                == 2 * N * 32
            assert got["env_steps_per_sec"] > 0
            assert sorted(port._inflight.values(), key=id) == \
                sorted(port.workers, key=id)
    finally:
        port.stop()
        ref.stop()


@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_offpolicy_remote_sampling_matches_the_reference(clusters, algo):
    make, cls, jcls, post, runner_kwargs = {
        "dqn": (dqn, DQNConfig, JDQNConfig, "transitions",
                {"act_mode": "epsilon_greedy"}),
        "sac": (sac, SACConfig, JSACConfig, "transitions",
                {"act_mode": "categorical"}),
    }[algo]
    port, ref = build(make, cls, jcls)
    try:
        carry_weights(port, ref)
        kw = {"epsilon": 1.0} if algo == "dqn" else {}
        check_round(port, port.sample_round(port._weights, **kw),
                    ref_round(ref, **kw), post, runner_kwargs, **kw)
        got, want = port.train(), ref.train()
        assert set(got) == set(want)
        assert got["timesteps_this_iter"] == want["timesteps_this_iter"] \
            == WORKERS * N * 16
        assert got["buffer_size"] == want["buffer_size"]
    finally:
        port.stop()
        ref.stop()


def test_dqn_and_bc_with_the_learner_remote(clusters, tmp_path):
    w = JsonWriter(str(tmp_path))
    runner = EnvRunner("CartPole-v1", num_envs=N, seed=1)
    batch, _ = runner.sample(16)
    w.write({k: batch[k] for k in ("obs", "actions", "rewards")})
    w.close()
    algos = [
        dqn(DQNConfig).resources(learner_device="cpu", learner_mode="remote"),
        (BCConfig().offline_data(str(tmp_path))
         .environment("CartPole-v1", num_envs_per_worker=N)
         .rollouts(rollout_fragment_length=16)
         .training(train_batch_size=32, train_intensity=2)
         .resources(learner_device="cpu", learner_mode="remote")
         .debugging(seed=0)),
    ]
    for cfg in algos:
        algo = cfg.build()
        try:
            assert algo.learner_group.mode == "remote"
            for _ in range(2):
                result = algo.train()
            assert np.isfinite(result["loss"])
            w = algo.get_weights()
            assert all(np.isfinite(x).all() for x in tree_leaves(w))
        finally:
            algo.stop()
        assert algo.learner_group._actor is None


def test_to_dataset_rows_are_the_references(clusters, tmp_path):
    from ray_tpu.rllib.offline import to_dataset as jto_dataset
    from ray_tpu_torch.rllib.offline import to_dataset

    rng = np.random.default_rng(0)
    w = JsonWriter(str(tmp_path))
    for n in (5, 7):
        w.write(SampleBatch({
            "obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "terminateds": rng.random(n) < 0.3}))
    w.close()

    def rows(ds):
        return [{k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
                 for k, v in r.items()} for r in ds.take_all()]

    got = to_dataset(str(tmp_path), parallelism=3)
    want = jto_dataset(str(tmp_path), parallelism=3)
    assert type(got).__module__ == "ray_tpu_torch.data.dataset"
    assert rows(got) == rows(want)
    assert got.count() == 12


def test_nothing_left_after_shutdown(clusters):
    assert_nothing_left(clusters)

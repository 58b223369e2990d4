"""Port vs JAX on the CPU: the off-policy and offline learners
(ray_tpu_torch.rllib.algorithms.dqn, sac, bc against ray_tpu.rllib's), on
the reference's initial parameters and targets carried across
(`set_trees`) and on f32 replay batches made with numpy from a seed: PER
weights that are not uniform, some terminations and some truncations.

- Every leaf's gradient, through Adam's first moment after one update
  (mu = 0.1·g, with grad_clip high enough that no clip applies: Adam's
  first step alone would hide a gradient off by a uniform factor), within
  1e-5 of the leaf's largest element; DQN with double_q on and off, SAC
  with autotune_alpha on (log_alpha's gradient is there) and off (it is
  zero), BC. Leaves no loss reaches (the unused value heads) take zero
  gradients in both.
- Seven updates on seven batches, DQN's target synced at updates 3 and 6:
  every metric, the |TD| errors, the parameters (log_alpha included) and
  the targets within 1e-5. A DQN learner whose target aliases its
  parameters (from the start, or from a sync on) fails that check.
- One read of the device an update; the traps of the reference's
  arithmetic: truncation as terminal, polyak averaging's rounding order,
  argmax ties, the state on the host.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.models import mlp_actor_critic_apply as japply
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.learner import transition_columns
from ray_tpu_torch.rllib.models import mlp_actor_critic_apply, tree_leaves
from ray_tpu_torch.rllib.sample_batch import SampleBatch

OBS_DIM, NUM_ACTIONS, HIDDENS = 4, 3, (64, 64)
N = 256
GRAD_TOL = 1e-5                       # of each leaf's largest element
TOL = dict(rtol=1e-5, atol=1e-5)      # parameters, targets, |TD| errors
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
UPDATES, SYNC_EVERY = 7, 3

LEARNERS = {
    "dqn": (jdqn.DQNLearner, tdqn.DQNLearner, dict(target_update_freq=SYNC_EVERY)),
    "dqn-single-q": (jdqn.DQNLearner, tdqn.DQNLearner,
                     dict(target_update_freq=SYNC_EVERY, double_q=False)),
    "sac": (jsac.SACLearner, tsac.SACLearner, dict(tau=0.05)),
    "sac-fixed-alpha": (jsac.SACLearner, tsac.SACLearner,
                        dict(tau=0.05, autotune_alpha=False)),
    "bc": (jbc.BCLearner, tbc.BCLearner, dict(lr=1e-3)),
}


def replay_batch(seed: int, n: int = N) -> SampleBatch:
    """Rewards wide enough that DQN's Huber loss takes both branches."""
    rng = np.random.default_rng(seed)
    term = rng.random(n) < 0.1
    return SampleBatch({
        SampleBatch.OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, NUM_ACTIONS, n),
        SampleBatch.REWARDS: rng.normal(0.5, 2.0, n).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        SampleBatch.TERMINATEDS: term,
        SampleBatch.TRUNCATEDS: (rng.random(n) < 0.1) & ~term,
        "weights": rng.uniform(0.1, 1.0, n).astype(np.float32),
    })


def pair(name, **kw):
    """The reference learner and the port's on the CPU, the port holding
    the reference's initial parameters and targets."""
    jcls, tcls, base = LEARNERS[name]
    kw = {**base, **kw}
    ref = jcls(OBS_DIM, NUM_ACTIONS, hiddens=HIDDENS, seed=0, **kw)
    port = tcls(OBS_DIM, NUM_ACTIONS, hiddens=HIDDENS, seed=0, device="cpu", **kw)
    port.set_trees(jax.device_get(ref._state))
    return ref, port


def ref_adam(ref):
    """The reference's ScaleByAdamState: optax.chain(clip_by_global_norm,
    adam) keeps it at opt_state[1][0]."""
    return jax.device_get(ref._state["opt_state"][1][0])


def unreached(name):
    """Leaf indexes (sorted-key order) that no loss of `name` reaches: the
    value heads ("vf" subtrees), and log_alpha under a fixed alpha."""
    jcls, tcls, kw = LEARNERS[name]
    port = tcls(OBS_DIM, NUM_ACTIONS, hiddens=HIDDENS, seed=0, device="cpu", **kw)
    names = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            names.append(path)
    walk(port.params, ())
    return {i for i, p in enumerate(names)
            if "vf" in p or (p == ("log_alpha",) and name == "sac-fixed-alpha")}


@pytest.mark.parametrize("name", list(LEARNERS))
def test_every_leaf_gradient_matches_jax_through_adams_first_moment(name):
    ref, port = pair(name, grad_clip=1e6)
    batch = replay_batch(0)
    ref.update(batch)
    port.update(batch)
    want = jax.tree_util.tree_leaves(ref_adam(ref).mu)
    got = tree_leaves(port.get_state()["opt_state"]["mu"])
    assert len(got) == len(want) == len(port._leaves)
    zero = unreached(name)
    assert len(zero) >= 6
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        if i in zero:
            assert not g.any() and not w.any(), f"leaf {i} reached"
            continue
        assert np.abs(w).max() > 0, f"leaf {i}"
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, f"leaf {i}: {err:.3e}"
    if name == "sac":  # log_alpha is the first leaf; autotune reaches it
        assert got[0] != 0
    assert port._optimizer.count == int(ref_adam(ref).count) == 1


def check_updates(ref, port, updates=UPDATES):
    """`updates` updates on as many batches: metrics, |TD| errors,
    parameters and targets held to the reference's after each."""
    for u in range(updates):
        batch = replay_batch(100 + u)
        want, got = ref.update(batch), port.update(batch)
        assert set(got) == set(want)
        for k in want:
            if k == "td_errors":
                assert got[k].dtype == np.float32 and got[k].shape == (N,)
                np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f"{u} {k}")
            else:
                np.testing.assert_allclose(got[k], want[k], **METRIC_TOL,
                                           err_msg=f"update {u}: {k}")
        state = jax.device_get(ref._state)
        for key in ("params", "target"):
            if key not in state:
                continue
            mine = tree_leaves(port.get_state()[key])
            theirs = jax.tree_util.tree_leaves(state[key])
            assert len(mine) == len(theirs)
            for i, (a, b) in enumerate(zip(mine, theirs)):
                np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                           err_msg=f"update {u}: {key} leaf {i}")


@pytest.mark.parametrize("name", list(LEARNERS))
def test_several_updates_match_jax(name):
    ref, port = pair(name)
    if name.startswith("dqn"):  # both Huber branches
        _, aux = port.loss_fn(port.params, transition_columns(replay_batch(100), "cpu"))
        td = aux["td"].detach().abs()
        assert (td < 1).any() and (td > 1).any()
    check_updates(ref, port)
    assert port._step == UPDATES


def aliased_from_the_start(learner):
    learner.target = learner.params


def aliased_at_the_sync(learner):
    learner._sync_target = lambda: setattr(learner, "target", learner.params)


@pytest.mark.parametrize("mutate", [aliased_from_the_start, aliased_at_the_sync])
def test_a_target_that_aliases_the_parameters_fails(mutate):
    """The reference's sync shares immutable arrays; a torch target sharing
    the live tensors follows every later step, and the check sees it."""
    ref, port = pair("dqn")
    mutate(port)
    with pytest.raises(AssertionError):
        check_updates(ref, port)


def test_the_dqn_target_is_a_snapshot_synced_after_the_step():
    """The initial target is a copy of the initial parameters (its own
    tensors); at every target_update_freq-th update it becomes a copy of
    the parameters after that update's step, and stays so until the next."""
    _, port = pair("dqn")
    assert not {t.data_ptr() for t in tree_leaves(port.target)} & {
        p.data_ptr() for p in port._leaves}
    snapshot = tree_leaves(port.get_state()["params"])
    for u in range(1, UPDATES + 1):
        port.update(replay_batch(u))
        state = port.get_state()
        params = tree_leaves(state["params"])
        if u % SYNC_EVERY == 0:
            snapshot = params
        target = tree_leaves(state["target"])
        assert all(np.array_equal(t, s) for t, s in zip(target, snapshot)), u
        assert (u % SYNC_EVERY == 0) == all(
            np.array_equal(t, p) for t, p in zip(target, params)), u


@pytest.mark.parametrize("name", ["dqn", "sac", "bc"])
def test_one_device_read_an_update(name, monkeypatch):
    _, port = pair(name)
    reads = []
    for method in ("item", "tolist", "numpy", "__float__", "__bool__", "cpu"):
        orig = getattr(torch.Tensor, method)

        def counted(self, *a, _orig=orig, _name=method, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, method, counted)
    port.update(replay_batch(0))
    monkeypatch.undo()
    assert reads == (["item"] if name == "bc" else ["tolist"])


def test_truncation_counts_as_terminal():
    """done = clip(terminated + truncated, 0, 1), as the reference's: a
    truncated row's target does not bootstrap."""
    batch = replay_batch(0)
    cols = transition_columns(batch, "cpu")
    term, trunc = batch["terminateds"], batch["truncateds"]
    assert trunc.any() and term.any()
    assert np.array_equal(cols["dones"].numpy(), (term | trunc).astype(np.float32))
    ref, port = pair("dqn")
    _, aux = port.loss_fn(port.params, cols)
    q, _ = mlp_actor_critic_apply(port.params, cols["obs"])
    qa = q.gather(-1, cols["actions"][:, None])[:, 0]
    ends = torch.from_numpy(term | trunc)
    np.testing.assert_array_equal(
        aux["td"].detach()[ends].numpy(),
        (qa - cols["rewards"]).detach()[ends].numpy())


def test_polyak_rounds_in_the_references_order():
    """After one SAC update each target leaf is f32((1 − τ)·t) + f32(τ·o),
    bitwise, which torch.lerp's t + τ·(o − t) is not everywhere."""
    _, port = pair("sac")
    tau = np.float32(port.tau)
    before = tree_leaves(port.get_state()["target"])
    port.update(replay_batch(0))
    state = port.get_state()
    online = tree_leaves({k: state["params"][k] for k in ("q1", "q2")})
    lerp_differs = False
    for t, o, got in zip(before, online, tree_leaves(state["target"])):
        want = np.float32(1 - port.tau) * t + tau * o
        assert np.array_equal(got, want)
        lerp = torch.lerp(torch.from_numpy(t), torch.from_numpy(o), float(tau)).numpy()
        lerp_differs |= not np.array_equal(lerp, want)
    assert lerp_differs


def test_sac_defaults_and_weights():
    ref, port = pair("sac")
    assert port.target_entropy == ref.target_entropy == 0.6 * float(np.log(NUM_ACTIONS))
    assert isinstance(port.target_entropy, float)
    assert sorted(port.params) == ["log_alpha", "pi", "q1", "q2"]
    assert sorted(port.target) == ["q1", "q2"]
    w = port.get_weights()
    assert set(w) == {"pi", "vf"}
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        tree_leaves(w), jax.tree_util.tree_leaves(ref.get_weights())))
    port.set_weights(jax.tree_util.tree_map(lambda x: np.asarray(x) + 1, w))
    assert np.array_equal(port.get_weights()["pi"][0]["b"], w["pi"][0]["b"] + 1)
    assert np.array_equal(port.get_state()["params"]["q1"]["pi"][0]["b"],
                          np.asarray(ref._state["params"]["q1"]["pi"][0]["b"]))


def test_argmax_ties_go_to_the_first_index_as_in_jax():
    q = np.asarray([[1, 1, 0], [0, 2, 2], [3, 3, 3], [-1, 0, 0]], np.float32)
    want = np.asarray(jax.numpy.argmax(q, axis=-1))
    assert np.array_equal(torch.argmax(torch.from_numpy(q), dim=-1).numpy(), want)
    assert np.array_equal(want, [0, 1, 0, 1])
    # and on the Q values of a batch with tied rows, through both models
    _, port = pair("dqn")
    obs = np.zeros((8, OBS_DIM), np.float32)
    q_port, _ = mlp_actor_critic_apply(port.params, torch.from_numpy(obs))
    q_ref, _ = japply(jax.device_get(port.get_weights()), obs)
    assert np.array_equal(torch.argmax(q_port, -1).numpy(),
                          np.asarray(jax.numpy.argmax(q_ref, -1)))


@pytest.mark.parametrize("name", ["dqn", "sac", "bc"])
def test_state_round_trip_on_the_host(name):
    _, port = pair(name)
    port.update(replay_batch(0))
    state = port.get_state()
    assert all(isinstance(x, (np.ndarray, int)) for x in tree_leaves(state))
    assert ("target" in state) == (name != "bc")
    other = LEARNERS[name][1](OBS_DIM, NUM_ACTIONS, hiddens=HIDDENS, seed=9,
                              device="cpu", **LEARNERS[name][2])
    other.set_state(state)
    batch = replay_batch(1)
    a, b = port.update(batch), other.update(batch)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for x, y in zip(tree_leaves(port.get_state()), tree_leaves(other.get_state())):
        assert np.array_equal(x, y)

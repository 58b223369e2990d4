"""Port vs JAX package on the CPU: the replay buffers
(ray_tpu_torch.rllib.replay_buffers against ray_tpu.rllib.replay_buffers),
host numpy in both. The reference's three buffer tests
(tests/test_rllib_dqn.py::TestReplayBuffers) run on the port; then the
same seed and the same adds give the reference's samples, importance
weights, priorities and sum tree bit for bit, through wraparound,
priority updates and both buffers' draws.
"""

import numpy as np
import pytest

from ray_tpu.rllib import replay_buffers as jrb
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.rllib.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _batch(n, base=0, cls=SampleBatch):
    return cls({
        SampleBatch.OBS: np.arange(n, dtype=np.float32)[:, None] + base,
        SampleBatch.ACTIONS: np.zeros(n, np.int64),
        SampleBatch.REWARDS: np.arange(n, dtype=np.float32) + base,
    })


class TestReplayBuffers:
    """The reference's tests, on the port."""

    def test_ring_wraparound_and_uniform_sample(self):
        buf = ReplayBuffer(capacity=8, seed=0)
        buf.add(_batch(6))
        assert len(buf) == 6
        buf.add(_batch(6, base=100))  # wraps: keeps the latest 8
        assert len(buf) == 8
        s = buf.sample(64)
        assert len(s) == 64
        # rows 4..5 of the first batch were overwritten by wraparound
        assert set(np.unique(s[SampleBatch.REWARDS])) <= (
            {4.0, 5.0} | {100.0 + i for i in range(6)}
        )

    def test_prioritized_sampling_bias_and_weights(self):
        buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, beta=1.0, seed=1)
        buf.add(_batch(32))
        # row 7 gets 100x the priority of everything else
        prios = np.ones(32)
        prios[7] = 100.0
        buf.update_priorities(np.arange(32), prios)
        s = buf.sample(512)
        counts = np.bincount(s["batch_indexes"], minlength=32)
        assert counts[7] > 0.5 * 512  # ~76% expected mass
        # importance weights: the over-sampled row has the SMALLEST weight
        w_by_idx = {}
        for i, w in zip(s["batch_indexes"], s["weights"]):
            w_by_idx[int(i)] = float(w)
        assert w_by_idx[7] == min(w_by_idx.values())
        assert max(w_by_idx.values()) <= 1.0 + 1e-6

    def test_priority_update_changes_distribution(self):
        buf = PrioritizedReplayBuffer(capacity=16, alpha=1.0, seed=2)
        buf.add(_batch(16))
        buf.update_priorities(np.arange(16), np.full(16, 1e-6))
        buf.update_priorities(np.asarray([3]), np.asarray([1000.0]))
        s = buf.sample(128)
        assert np.mean(s["batch_indexes"] == 3) > 0.9


def same_draws(port, ref, rng, rounds=6):
    """Adds (wrapping the ring), samples and, for PER, priority updates
    from |TD|-like draws, the same on both; every sample equal bit for
    bit, column by column, and the buffers' state after each round."""
    prioritized = isinstance(port, PrioritizedReplayBuffer)
    for r in range(rounds):
        n = int(rng.integers(5, 40))
        cols = {
            SampleBatch.OBS: rng.standard_normal((n, 3)).astype(np.float32),
            SampleBatch.ACTIONS: rng.integers(0, 4, n),
            SampleBatch.REWARDS: rng.standard_normal(n).astype(np.float32),
            SampleBatch.TERMINATEDS: rng.random(n) < 0.2,
        }
        got = port.add(SampleBatch({k: v.copy() for k, v in cols.items()}))
        want = ref.add(JSampleBatch({k: v.copy() for k, v in cols.items()}))
        assert np.array_equal(got, want)
        kw = {"beta": 0.7} if prioritized and r % 2 else {}
        a, b = port.sample(48, **kw), ref.sample(48, **kw)
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (r, k)
        if prioritized:
            td = np.abs(rng.standard_normal(48)).astype(np.float32) * 3
            port.update_priorities(a["batch_indexes"], td)
            ref.update_priorities(b["batch_indexes"], td)
            assert np.array_equal(port._tree, ref._tree)
            assert port._tree.dtype == np.float64
            assert port._max_prio == ref._max_prio
        assert len(port) == len(ref) and port._idx == ref._idx
        for k in ref._cols:
            assert np.array_equal(port._cols[k], ref._cols[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_uniform_buffer_draws_the_references_rows(seed):
    rng = np.random.default_rng(100 + seed)
    same_draws(ReplayBuffer(capacity=64, seed=seed),
               jrb.ReplayBuffer(capacity=64, seed=seed), rng)


@pytest.mark.parametrize("capacity,alpha,beta", [(64, 0.6, 0.4), (50, 1.0, 1.0),
                                                 (100, 0.0, 0.4)])
def test_prioritized_buffer_draws_the_references_rows_and_weights(capacity, alpha, beta):
    """capacity 50 and 100: a sum tree over 64 and 128 leaves, some never
    filled; alpha 0: every priority 1."""
    kw = dict(capacity=capacity, alpha=alpha, beta=beta, seed=3)
    port, ref = PrioritizedReplayBuffer(**kw), jrb.PrioritizedReplayBuffer(**kw)
    assert port._tree_cap == ref._tree_cap
    same_draws(port, ref, np.random.default_rng(capacity))
    s = port.sample(32)
    assert s["weights"].dtype == np.float32 and s["weights"].max() == 1.0


def test_buffer_errors_are_the_references():
    for cls in (ReplayBuffer, PrioritizedReplayBuffer):
        with pytest.raises(ValueError, match="empty"):
            cls(capacity=4).sample(1)
    with pytest.raises(ValueError, match="capacity"):
        ReplayBuffer(capacity=0)
    with pytest.raises(ValueError, match="alpha"):
        PrioritizedReplayBuffer(capacity=4, alpha=-1.0)
    assert len(ReplayBuffer(4).add(_batch(0))) == 0
    assert ReplayBuffer(4).stats() == jrb.ReplayBuffer(4).stats()

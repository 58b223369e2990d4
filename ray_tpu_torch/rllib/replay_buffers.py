"""Replay buffers: uniform ring buffer + proportional prioritized replay.

The port's copy of ray_tpu/rllib/replay_buffers.py, line for line: host
numpy, on the host CPU beside the rollout runner, as in the reference;
only a sampled batch goes to the learner's device (the learner's
`learner_device`, the card unless the caller asks for the CPU). With the
same seed and the same adds it draws the reference's `batch_indexes` and
`weights` bit for bit.

Parity: rllib/utils/replay_buffers/ (ReplayBuffer, PrioritizedReplayBuffer
— Schaul et al. 2016) — the storage layer behind every off-policy
algorithm (DQN/SAC/...). Storage is column-oriented numpy rings (one array
per SampleBatch column, allocated on first add), so sampling N indices is
a vectorized gather — no per-row Python objects, and a sampled batch is
already in the learner's layout.

PrioritizedReplayBuffer keeps p^alpha in a binary sum-tree (numpy array,
2*capacity nodes): O(log n) updates, O(n_samples·log n) stratified
proportional sampling, importance weights normalized by the max weight in
the batch (the standard PER recipe).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform-sampling ring buffer over SampleBatch rows."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._idx = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def _ensure_storage(self, batch: SampleBatch) -> None:
        for k, v in batch.items():
            if k not in self._cols:
                arr = np.asarray(v)
                self._cols[k] = np.zeros(
                    (self.capacity,) + arr.shape[1:], arr.dtype
                )

    def add(self, batch: SampleBatch) -> np.ndarray:
        """Append all rows; returns the storage indices they landed in."""
        n = len(batch)
        if n == 0:
            return np.asarray([], np.int64)
        self._ensure_storage(batch)
        idx = (self._idx + np.arange(n)) % self.capacity
        for k, col in self._cols.items():
            col[idx] = np.asarray(batch[k])[:n]
        self._idx = int((self._idx + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, num_items: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.integers(0, self._size, size=num_items)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        out = SampleBatch({k: col[idx] for k, col in self._cols.items()})
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def stats(self) -> Dict[str, float]:
        return {"size": self._size, "capacity": self.capacity}


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed)
        if not 0.0 <= alpha:
            raise ValueError("alpha must be >= 0")
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        # perfect binary sum-tree over `tree_cap` leaves
        self._tree_cap = 1
        while self._tree_cap < capacity:
            self._tree_cap *= 2
        self._tree = np.zeros(2 * self._tree_cap, np.float64)
        self._max_prio = 1.0

    # ------------------------------------------------------------- sum-tree
    def _tree_set(self, idx: np.ndarray, prio_alpha: np.ndarray) -> None:
        pos = idx + self._tree_cap
        self._tree[pos] = prio_alpha
        pos //= 2
        # walk each touched path up; vectorized per level
        while np.any(pos >= 1):
            pos = np.unique(pos[pos >= 1])
            self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]
            pos //= 2

    def _tree_find(self, mass: np.ndarray) -> np.ndarray:
        """Descend: for each probability mass, the leaf whose prefix-sum
        interval contains it."""
        pos = np.ones_like(mass, dtype=np.int64)
        while pos[0] < self._tree_cap:
            left = self._tree[2 * pos]
            go_right = mass > left
            mass = np.where(go_right, mass - left, mass)
            pos = 2 * pos + go_right.astype(np.int64)
        return pos - self._tree_cap

    # ------------------------------------------------------------- public
    def add(self, batch: SampleBatch) -> np.ndarray:
        idx = super().add(batch)
        if len(idx):
            self._tree_set(
                idx, np.full(len(idx), self._max_prio ** self.alpha)
            )
        return idx

    def sample(self, num_items: int, beta: Optional[float] = None) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        beta = self.beta if beta is None else beta
        total = self._tree[1]
        # stratified: one draw per equal-mass segment
        seg = total / num_items
        mass = (np.arange(num_items) + self._rng.random(num_items)) * seg
        idx = np.clip(self._tree_find(mass), 0, self._size - 1)
        batch = self._take(idx)
        probs = self._tree[idx + self._tree_cap] / max(total, 1e-12)
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        return batch

    def update_priorities(self, idx: np.ndarray, prios: np.ndarray) -> None:
        prios = np.abs(np.asarray(prios, np.float64)) + self.eps
        self._max_prio = max(self._max_prio, float(prios.max()))
        self._tree_set(np.asarray(idx, np.int64), prios ** self.alpha)

"""SampleBatch: columnar rollout storage for the RL stack.

The port's copy of ray_tpu/rllib/sample_batch.py: a dict of numpy columns
on the host (rollouts run on the host CPU). `as_jax` becomes `as_torch`:
the learner's side takes the columns to its device, through pinned host
memory and a non-blocking copy when that device is a GPU.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch


class SampleBatch(dict):
    """A dict of equally-long numpy columns. Length = first dim of any column.

    Keys starting with "_" are per-batch metadata (e.g. "_bootstrap_obs" for
    v-trace batches): exempt from the equal-length rule, carried through
    slice/take untouched, and excluded from row counting.
    """

    OBS = "obs"
    NEXT_OBS = "next_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"
    EPS_ID = "eps_id"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)
        lens = {len(v) for k, v in self.items() if not k.startswith("_")}
        if len(lens) > 1:
            raise ValueError(
                f"ragged SampleBatch columns: "
                f"{ {k: len(v) for k, v in self.items()} }"
            )

    def __len__(self) -> int:
        for k, v in self.items():
            if not k.startswith("_"):
                return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({
            k: (v if k.startswith("_") else v[start:end])
            for k, v in self.items()
        })

    def take(self, indices: np.ndarray) -> "SampleBatch":
        return SampleBatch({
            k: (v if k.startswith("_") else v[indices])
            for k, v in self.items()
        })

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return self.take(perm)

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = len(self)
        for start in range(0, n - size + 1, size):
            yield self.slice(start, start + size)

    @staticmethod
    def concat_samples(batches: Sequence["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if len(b) > 0]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        # metadata ("_"-prefixed) is per-batch, not per-row: concatenating
        # it would corrupt e.g. _bootstrap_obs ([N,D] + [N,D] -> [2N,D]
        # against [2T,N] rows); keep the last batch's copy instead
        return SampleBatch({
            k: (
                batches[-1][k] if k.startswith("_")
                else np.concatenate([b[k] for b in batches], axis=0)
            )
            for k in keys
        })

    def split_by_episode(self) -> List["SampleBatch"]:
        """Split on EPS_ID boundaries (rows must be grouped by episode)."""
        if self.EPS_ID not in self or len(self) == 0:
            return [self]
        eps = self[self.EPS_ID]
        cuts = np.flatnonzero(eps[1:] != eps[:-1]) + 1
        out, prev = [], 0
        for c in list(cuts) + [len(self)]:
            out.append(self.slice(prev, c))
            prev = c
        return out

    def as_torch(self, device="cuda") -> Dict[str, torch.Tensor]:
        return columns_to(self, device)


def columns_to(columns: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Numpy columns → tensors on `device`, no column synchronising the
    host: on a GPU each goes through pinned memory with a non-blocking
    copy (the caching host allocator keeps the pinned buffer until the
    copy is done); on the CPU the tensor shares the array's memory."""
    device = torch.device(device)
    out = {}
    for k, v in columns.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out

"""Distributed two-stage (push-based) shuffle for Datasets.

Parity: python/ray/data/_internal/push_based_shuffle.py — the reference's
map/reduce shuffle that powers sort, random_shuffle, and hash repartition at
scale. Same shape here:

  stage 1 (map):    one task per input block partitions its rows into R
                    outputs (range-partition for sort, hash for groupby,
                    seeded-random for shuffle). Each of the R partition
                    blocks is a SEPARATE return object (num_returns=R), so
                    a reducer pulls exactly its slice of each map output —
                    never the whole block.
  stage 2 (reduce): one task per partition concatenates its R inputs (and
                    sorts them for sort()).

The driver touches only object refs and (for sort) a small sample of key
values to compute partition boundaries — no data-sized driver memory, which
is the scale bug this replaces (the old sort() concatenated the whole
dataset on the driver).
"""

from __future__ import annotations

import builtins
import zlib
from typing import Any, Callable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    block_concat,
    block_num_rows,
    block_take,
)


def _empty_like(block: Block) -> Block:
    return {k: v[:0] for k, v in block.items()}


def _partition_by_indices(block: Block, part_ids: np.ndarray,
                          num_parts: int) -> List[Block]:
    return [
        block_take(block, np.flatnonzero(part_ids == j))
        for j in builtins.range(num_parts)
    ]


def shuffle_blocks(
    refs: List[Any],
    partitioner: Callable[[Block, int], np.ndarray],
    num_partitions: int,
    reduce_fn: Optional[Callable[[Block], Block]] = None,
) -> List[Any]:
    """Generic two-stage shuffle over block refs → list of partition refs.

    partitioner(block, num_partitions, block_index) -> int array [rows] of
    partition ids (block_index distinguishes same-content blocks, e.g. for
    seeded random scatter).
    reduce_fn: applied to each reducer's concatenated block (e.g. local sort).
    """
    import ray_tpu_torch

    R = num_partitions
    if not refs:
        return []

    def map_stage(block: Block, idx: int):
        ids = partitioner(block, R, idx)
        parts = _partition_by_indices(block, np.asarray(ids), R)
        return tuple(parts) if R > 1 else parts[0]

    def reduce_stage(*parts: Block) -> Block:
        live = [p for p in parts if p and block_num_rows(p)]
        if not live:
            live = [p for p in parts if p is not None]
        out = block_concat(live) if len(live) > 1 else live[0]
        return reduce_fn(out) if reduce_fn is not None else out

    mapper = ray_tpu_torch.remote(num_cpus=0.25, num_returns=R)(map_stage)
    reducer = ray_tpu_torch.remote(num_cpus=0.25)(reduce_stage)

    map_out = [mapper.remote(r, i) for i, r in enumerate(refs)]
    if R == 1:
        map_out = [[m] for m in map_out]
    # reducer j pulls column j of the map-output matrix (refs as top-level
    # args so the executing worker resolves/fetches them, possibly over the
    # native transfer plane)
    return [
        reducer.remote(*[map_out[i][j] for i in builtins.range(len(refs))])
        for j in builtins.range(R)
    ]


# ------------------------------------------------------------------- sort
def sample_boundaries(refs: List[Any], key: str, num_partitions: int,
                      sample_size: int = 256) -> np.ndarray:
    """Stage 0 of distributed sort: sample key values from every block and
    cut R-1 quantile boundaries. Driver memory = O(blocks × sample_size)."""
    import ray_tpu_torch

    def sample(block: Block):
        col = np.asarray(block[key])
        if len(col) <= sample_size:
            return col
        idx = np.random.default_rng(0).choice(
            len(col), size=sample_size, replace=False
        )
        return col[idx]

    sampler = ray_tpu_torch.remote(num_cpus=0.25)(sample)
    samples = ray_tpu_torch.get([sampler.remote(r) for r in refs], timeout=600)
    allv = np.sort(np.concatenate([s for s in samples if len(s)]))
    if len(allv) == 0:
        return np.asarray([])
    qs = [len(allv) * j // num_partitions for j in range(1, num_partitions)]
    return allv[qs]


def sort_shuffle(refs: List[Any], key: str, descending: bool,
                 num_partitions: int) -> List[Any]:
    """Distributed range-partitioned sort → partition refs in global order."""
    bounds = sample_boundaries(refs, key, num_partitions)

    def partitioner(block: Block, R: int, idx: int) -> np.ndarray:
        col = np.asarray(block[key])
        ids = np.searchsorted(bounds, col, side="right")
        if descending:
            ids = (R - 1) - ids
        return ids

    def local_sort(block: Block) -> Block:
        order = np.argsort(np.asarray(block[key]), kind="stable")
        if descending:
            order = order[::-1]
        return block_take(block, order)

    return shuffle_blocks(refs, partitioner, num_partitions, local_sort)


# ---------------------------------------------------------------- shuffle
def random_shuffle_blocks(refs: List[Any], seed: Optional[int],
                          num_partitions: int) -> List[Any]:
    """Global random shuffle: rows scatter uniformly over reducers, each
    reducer permutes its concatenation."""
    base = 0 if seed is None else int(seed)

    def partitioner(block: Block, R: int, idx: int) -> np.ndarray:
        n = block_num_rows(block)
        # deterministic per (seed, block index): reruns shuffle identically,
        # distinct blocks scatter independently
        rng = np.random.default_rng((base, idx))
        return rng.integers(0, R, size=n)

    def permute(block: Block) -> Block:
        n = block_num_rows(block)
        rng = np.random.default_rng((base + 1, n))
        return block_take(block, rng.permutation(n))

    return shuffle_blocks(refs, partitioner, num_partitions, permute)


# ----------------------------------------------------------------- groupby
def hash_partition(refs: List[Any], key: str,
                   num_partitions: int) -> List[Any]:
    """Hash-partition blocks by key: all rows of one key land in exactly one
    partition (the basis for shuffled groupby / map_groups)."""
    def partitioner(block: Block, R: int, idx: int) -> np.ndarray:
        col = block[key]
        arr = np.asarray(col)
        if arr.dtype.kind in "iub":
            return (arr.astype(np.int64) % R + R) % R
        # strings/objects: process-independent hash. builtins.hash is salted
        # per interpreter (PYTHONHASHSEED), and map tasks run in separate
        # worker processes — the same key MUST route to the same partition
        # from every map task, so use crc32 over the repr bytes instead.
        # Integers that arrive via an object-dtype block (e.g. a mixed-type
        # column) must agree with the int64 fast path above, so they keep
        # the value % R rule.
        def one(x):
            if isinstance(x, (int, np.integer)):  # incl. bool: matches "b" path
                return int(x) % R
            return zlib.crc32(repr(x).encode("utf-8", "surrogatepass")) % R

        return np.asarray([one(x) for x in arr.tolist()], dtype=np.int64)

    return shuffle_blocks(refs, partitioner, num_partitions)

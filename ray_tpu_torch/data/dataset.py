"""Dataset: lazy, distributed, streaming-executed data pipelines.

The port's copy of ray_tpu/data/dataset.py. Parity:
python/ray/data/dataset.py (lazy `Dataset`; map_batches :381,
iter_batches :2876) + read_api.py. A Dataset is a plan (chain of
operators) over blocks; nothing executes until a consumption call.
Execution streams through remote tasks/actor pools (executor.py);
batches reach the card through pinned staging buffers copied on a side
stream (iterator.py) — the reference's iter_torch_batches.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch.data import datasource as ds_mod
from ray_tpu_torch.data.block import (
    Block,
    block_concat,
    block_from_rows,
    block_num_rows,
    block_rows,
    block_slice,
    block_take,
)
from ray_tpu_torch.data.executor import (
    ActorPoolStrategy,
    FromRefsOp,
    LimitOp,
    MapBatchesOp,
    Op,
    ReadOp,
    RechunkOp,
    StreamingExecutor,
)


class Dataset:
    def __init__(self, ops: List[Op], materialized_refs: Optional[List[Any]] = None):
        self._ops = ops
        self._materialized = materialized_refs

    def _base_ops(self) -> List[Op]:
        """Plan prefix for chaining: materialized datasets re-enter the
        stream through their refs (transforms after union/repartition/sort
        must not silently drop the data)."""
        if self._materialized is not None:
            return [FromRefsOp(list(self._materialized))]
        return list(self._ops)

    # ------------------------------------------------------------ transforms
    def map_batches(
        self,
        fn: Any,
        *,
        batch_size: Optional[int] = None,
        compute: Optional[ActorPoolStrategy] = None,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
    ) -> "Dataset":
        """Apply fn to batches (blocks). `fn` may be a function or a callable
        class (constructed once per actor with ActorPoolStrategy compute).
        batch_size=None applies fn per existing block (zero re-chunk cost);
        an explicit batch_size re-chunks the stream first."""
        ops = self._base_ops()
        if batch_size is not None:
            ops.append(RechunkOp(batch_size))
        ops.append(MapBatchesOp(fn=fn, compute=compute, fn_args=fn_args,
                                fn_kwargs=fn_kwargs))
        return Dataset(ops)

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def map_rows(block: Block) -> Any:
            from ray_tpu_torch.data.block import block_from_rows

            return block_from_rows([fn(r) for r in block_rows(block)])

        return self.map_batches(map_rows)

    def filter(self, pred: Callable[[Any], bool]) -> "Dataset":
        def filter_rows(block: Block) -> Block:
            keep = np.asarray([pred(r) for r in block_rows(block)], bool)
            from ray_tpu_torch.data.block import block_take

            return block_take(block, np.flatnonzero(keep))

        return self.map_batches(filter_rows)

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._base_ops() + [LimitOp(n)])

    def random_shuffle(self, seed: Optional[int] = None,
                       num_partitions: Optional[int] = None) -> "Dataset":
        """GLOBAL random shuffle via the two-stage push shuffle
        (data/shuffle.py ↔ reference push_based_shuffle.py): rows scatter
        uniformly over reducers, each reducer permutes. Any row can land in
        any output block; the driver only handles refs."""
        from ray_tpu_torch.data.shuffle import random_shuffle_blocks

        refs = list(self.iter_block_refs())
        out = random_shuffle_blocks(
            refs, seed, num_partitions or max(len(refs), 1)
        )
        return Dataset([], materialized_refs=out)


    def flat_map(self, fn: Callable[[Any], Sequence[Any]]) -> "Dataset":
        """Each row expands to zero or more rows."""
        def flat_rows(block: Block) -> Block:
            out = []
            for r in block_rows(block):
                out.extend(fn(r))
            return block_from_rows(out)

        return self.map_batches(flat_rows)

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets. EAGER: executes the upstream plans now and
        holds block refs (further transforms chain lazily on the refs)."""
        refs = list(self.materialize().iter_block_refs())
        for o in others:
            refs.extend(o.materialize().iter_block_refs())
        return Dataset([], materialized_refs=refs)

    def repartition(self, num_blocks: int) -> "Dataset":
        """Rebalance into `num_blocks` row-even blocks (EAGER; remote
        re-cut via the split machinery, no driver materialization)."""
        shards = self.split(num_blocks)
        refs = []
        import ray_tpu_torch

        # refs pass as TOP-LEVEL args so the executing worker resolves them
        merge = ray_tpu_torch.remote(num_cpus=0.25)(
            lambda *blocks: block_concat(blocks)
        )
        for sh in shards:
            rs = list(sh.iter_block_refs())
            refs.append(rs[0] if len(rs) == 1 else merge.remote(*rs))
        return Dataset([], materialized_refs=refs)

    def sort(self, key: str, descending: bool = False,
             num_partitions: Optional[int] = None) -> "Dataset":
        """Global sort by a column — DISTRIBUTED range-partitioned shuffle
        sort (data/shuffle.py ↔ reference push_based_shuffle.py + sort.py):
        sample key quantiles → range-partition map tasks → per-partition
        sort reducers. The driver holds only refs and the O(blocks×256)
        boundary sample, never a concatenated dataset."""
        from ray_tpu_torch.data.shuffle import sort_shuffle

        refs = list(self.iter_block_refs())
        if not refs:
            return Dataset([], materialized_refs=[])
        out = sort_shuffle(
            refs, key, descending, num_partitions or max(len(refs), 1)
        )
        return Dataset([], materialized_refs=out)

    def groupby(self, key: str) -> "GroupedDataset":
        return GroupedDataset(self, key)

    # ------------------------------------------------------------ execution
    def iter_block_refs(self, **executor_kwargs) -> Iterator[Any]:
        if self._materialized is not None:
            yield from self._materialized
            return
        executor = StreamingExecutor(**executor_kwargs)
        self._last_stats = executor.stats
        yield from executor.execute(self._ops)

    def stats(self) -> str:
        """Per-operator execution stats of the most recent run (parity:
        Dataset.stats() over _internal/stats.py instrumentation)."""
        stats = getattr(self, "_last_stats", None)
        if stats is None or not stats.ops:
            return "Dataset has not been executed yet (no stats)."
        return stats.summary()

    def materialize(self) -> "Dataset":
        """Execute the plan now; the result holds block refs (reference:
        Dataset.materialize → MaterializedDataset)."""
        if self._materialized is not None:
            return self
        refs = list(self.iter_block_refs())
        return Dataset([], materialized_refs=refs)

    # ------------------------------------------------------------ consumption
    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        prefetch_batches: int = 1,
        drop_last: bool = False,
        device: Any = None,
        sharding: Any = None,
    ) -> Iterator[Dict[str, Any]]:
        from ray_tpu_torch.data.iterator import iter_batches as _iter

        return _iter(
            self.iter_block_refs(),
            batch_size=batch_size,
            prefetch_batches=prefetch_batches,
            drop_last=drop_last,
            device=device,
            sharding=sharding,
        )

    def iter_rows(self) -> Iterator[Any]:
        import ray_tpu_torch

        for ref in self.iter_block_refs():
            yield from block_rows(ray_tpu_torch.get(ref))

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        import ray_tpu_torch

        return builtins.sum(
            block_num_rows(ray_tpu_torch.get(r)) for r in self.iter_block_refs()
        )

    def write_parquet(self, path: str) -> List[str]:
        """One parquet file per block via remote writer tasks (parity:
        Dataset.write_parquet); returns the written file paths."""
        import os

        import ray_tpu_torch

        os.makedirs(path, exist_ok=True)

        def write_block(block: Block, out_path: str) -> str:
            import pyarrow as pa
            import pyarrow.parquet as pq

            table = pa.table({k: np.asarray(v) for k, v in block.items()})
            pq.write_table(table, out_path)
            return out_path

        writer = ray_tpu_torch.remote(num_cpus=0.25)(write_block)
        refs = [
            writer.remote(r, os.path.join(path, f"part-{i:05d}.parquet"))
            for i, r in enumerate(self.iter_block_refs())
        ]
        return ray_tpu_torch.get(refs, timeout=600)

    def schema(self) -> Optional[Dict[str, str]]:
        import ray_tpu_torch

        for ref in self.iter_block_refs():
            block = ray_tpu_torch.get(ref)
            return {k: str(v.dtype) for k, v in block.items()}
        return None

    def split(self, n: int) -> List["Dataset"]:
        """Materialize and split into n row-balanced shards (per train worker;
        reference: Dataset.split / streaming_split).

        Blocks are NOT pulled to the driver: whole blocks pass through as
        refs, and only the blocks straddling a shard boundary are re-cut by
        remote slice tasks — concatenating the dataset driver-side held ~2x
        the full data in driver RAM on every fit()."""
        import ray_tpu_torch

        refs = list(self.materialize().iter_block_refs())
        count_rows = ray_tpu_torch.remote(num_cpus=0.25)(block_num_rows)
        counts = ray_tpu_torch.get([count_rows.remote(r) for r in refs], timeout=300)
        total = builtins.sum(counts)
        per = total // n
        slice_task = ray_tpu_torch.remote(num_cpus=0.25)(block_slice)
        shards: List[Dataset] = []
        block_i, offset = 0, 0  # offset: rows of block_i already consumed
        for i in builtins.range(n):  # `range` is shadowed by the read API
            want = total - (n - 1) * per if i == n - 1 else per
            shard_refs: List[Any] = []
            while want > 0 and block_i < len(refs):
                avail = counts[block_i] - offset
                if avail <= want and offset == 0:
                    shard_refs.append(refs[block_i])  # whole block, zero copy
                    want -= avail
                    block_i += 1
                else:
                    take = min(avail, want)
                    shard_refs.append(
                        slice_task.remote(refs[block_i], offset, offset + take)
                    )
                    want -= take
                    offset += take
                    if offset >= counts[block_i]:
                        block_i += 1
                        offset = 0
            shards.append(Dataset([], materialized_refs=shard_refs))
        return shards

    def __repr__(self):
        if self._materialized is not None:
            return f"MaterializedDataset({len(self._materialized)} blocks)"
        names = [getattr(op, "name", type(op).__name__) for op in self._ops]
        return f"Dataset({' -> '.join(names)})"




class GroupedDataset:
    """Per-key aggregations (parity: Dataset.groupby().count()/sum()/...).

    Two stages: remote per-block partial aggregates, then a driver-side
    combine over the (small) partials — full rows never land on the driver.
    """

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _partials(self, value_col: Optional[str]):
        import ray_tpu_torch

        key = self._key

        def partial(block: Block):
            out: Dict[Any, list] = {}
            ks = block[key]
            vs = block[value_col] if value_col else None
            for i in builtins.range(len(ks)):
                k = ks[i].item() if hasattr(ks[i], "item") else ks[i]
                e = out.setdefault(k, [0, 0.0, None, None])  # n, sum, min, max
                e[0] += 1
                if vs is not None:
                    v = float(vs[i])
                    e[1] += v
                    e[2] = v if e[2] is None else min(e[2], v)
                    e[3] = v if e[3] is None else max(e[3], v)
            return out

        run = ray_tpu_torch.remote(num_cpus=0.25)(partial)
        parts = ray_tpu_torch.get(
            [run.remote(r) for r in self._ds.iter_block_refs()], timeout=600
        )
        combined: Dict[Any, list] = {}
        for p in parts:
            for k, (n, s_, mn, mx) in p.items():
                e = combined.setdefault(k, [0, 0.0, None, None])
                e[0] += n
                e[1] += s_
                if mn is not None:
                    e[2] = mn if e[2] is None else min(e[2], mn)
                if mx is not None:
                    e[3] = mx if e[3] is None else max(e[3], mx)
        return combined

    def map_groups(self, fn: Callable[[Block], Any],
                   num_partitions: Optional[int] = None) -> Dataset:
        """Apply fn to each key's full group block (parity:
        GroupedData.map_groups). Backed by the distributed hash shuffle:
        every key's rows meet in exactly one partition task — the driver
        never materializes groups."""
        import ray_tpu_torch

        from ray_tpu_torch.data.shuffle import hash_partition

        key = self._key
        refs = list(self._ds.iter_block_refs())
        if not refs:
            return Dataset([], materialized_refs=[])
        parts = hash_partition(refs, key, num_partitions or max(len(refs), 1))

        def apply_groups(block: Block) -> Block:
            if key not in block or block_num_rows(block) == 0:
                return block  # empty hash partition: no groups landed here
            ks = block[key]
            keys = [k.item() if hasattr(k, "item") else k for k in ks]
            order: Dict[Any, list] = {}
            for i, k in enumerate(keys):
                order.setdefault(k, []).append(i)
            outs = []
            for k, idxs in order.items():
                sub = block_take(block, np.asarray(idxs))
                res = fn(sub)
                outs.append(res if isinstance(res, dict) else
                            block_from_rows([res]))
            return block_concat(outs) if outs else block

        run = ray_tpu_torch.remote(num_cpus=0.25)(apply_groups)
        return Dataset([], materialized_refs=[run.remote(p) for p in parts])

    def count(self) -> Dict[Any, int]:
        return {k: e[0] for k, e in self._partials(None).items()}

    def sum(self, col: str) -> Dict[Any, float]:
        return {k: e[1] for k, e in self._partials(col).items()}

    def mean(self, col: str) -> Dict[Any, float]:
        return {
            k: e[1] / e[0] for k, e in self._partials(col).items()
        }

    def min(self, col: str) -> Dict[Any, float]:
        return {k: e[2] for k, e in self._partials(col).items()}

    def max(self, col: str) -> Dict[Any, float]:
        return {k: e[3] for k, e in self._partials(col).items()}


# ---------------------------------------------------------------- read API
def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return Dataset([ReadOp(ds_mod.RangeDatasource(n, parallelism).read_tasks())])


def from_items(items: Sequence[Any], *, parallelism: int = 8) -> Dataset:
    return Dataset([ReadOp(ds_mod.ItemsDatasource(items, parallelism).read_tasks())])


def from_numpy(arrays: Union[np.ndarray, Sequence[np.ndarray]], column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return Dataset([ReadOp(ds_mod.NumpyDatasource(arrays, column).read_tasks())])


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    return Dataset([ReadOp(ds_mod.ParquetDatasource(paths, columns).read_tasks())])


def read_csv(paths) -> Dataset:
    return Dataset([ReadOp(ds_mod.CSVDatasource(paths).read_tasks())])


def read_json(paths) -> Dataset:
    """JSON-lines files (parity: ray.data.read_json)."""
    return Dataset([ReadOp(ds_mod.JSONDatasource(paths).read_tasks())])


def from_pandas(dfs) -> Dataset:
    """One block per DataFrame (parity: ray.data.from_pandas)."""
    if not isinstance(dfs, (list, tuple)):
        dfs = [dfs]
    blocks = [
        {c: np.asarray(df[c]) for c in df.columns} for df in dfs
    ]
    import ray_tpu_torch

    return Dataset([], materialized_refs=[ray_tpu_torch.put(b) for b in blocks])

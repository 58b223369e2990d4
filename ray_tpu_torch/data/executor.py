"""Streaming executor: pull-based pipelined execution of a Dataset plan.

The port's copy of ray_tpu/data/executor.py. Parity:
data/_internal/execution/streaming_executor.py:48 + operators/
map_operator.py:30 — operators form a chain; blocks flow as ObjectRefs;
each stage keeps a bounded number of remote tasks in flight, so the whole
pipeline streams with backpressure instead of materializing stage-by-stage
(bulk executor behavior). Compute strategies: stateless remote tasks
(default) or a reusable actor pool (`ActorPoolStrategy`) for expensive
per-worker setup — reference: map_operator.py task/actor variants.

One addition to the reference: `ActorPoolStrategy.num_gpus` (0 by
default) is the GPU lease each actor of the pool holds. A stage whose
actors open the card must ask for one: a worker without a GPU lease sees
every card, and the raylet may later lease that idle worker a card it
did not open (ROADMAP.md, the one-node runtime's deviations).

All scheduling here is host-side; the copy to the card happens in
iterator.py.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from ray_tpu_torch.data.block import Block, block_num_rows, normalize_batch

logger = logging.getLogger(__name__)


@dataclass
class ActorPoolStrategy:
    size: int = 2
    max_tasks_in_flight_per_actor: int = 2
    num_gpus: float = 0  # each actor's GPU lease (module docstring)


# ------------------------------------------------------------------ operators
@dataclass
class FromRefsOp:
    """Source op over already-materialized block refs (chaining transforms
    after union/repartition/sort/materialize)."""

    refs: list


@dataclass
class ReadOp:
    read_tasks: List[Callable[[], Block]]
    name: str = "Read"


@dataclass
class MapBatchesOp:
    fn: Any                       # callable block->batch, or callable CLASS
    name: str = "MapBatches"
    compute: Any = None           # None → tasks; ActorPoolStrategy → actors
    fn_args: tuple = ()
    fn_kwargs: Optional[dict] = None
    zero_rows_ok: bool = True     # filters may empty a block


@dataclass
class LimitOp:
    limit: int
    name: str = "Limit"


@dataclass
class RechunkOp:
    """Re-batch the block stream to exactly `batch_size` rows per block.

    Runs driver-side (blocks cross the driver once): correct and simple;
    the default map_batches(batch_size=None) path never pays this copy.
    """

    batch_size: int
    name: str = "Rechunk"


Op = Any


def _apply_fn(fn, block: Block, fn_args, fn_kwargs) -> Block:
    out = fn(block, *fn_args, **(fn_kwargs or {}))
    return normalize_batch(out)


class _MapActor:
    """Actor-pool worker: constructs a callable-class fn once, then maps
    blocks through it (reference: _MapWorker in map_operator.py)."""

    def __init__(self, fn_or_cls, fn_args, fn_kwargs):
        import inspect

        if inspect.isclass(fn_or_cls):
            self._fn = fn_or_cls(*fn_args, **(fn_kwargs or {}))
            self._args, self._kwargs = (), {}
        else:
            self._fn = fn_or_cls
            self._args, self._kwargs = fn_args, fn_kwargs or {}

    def map_block(self, block: Block) -> Block:
        return _apply_fn(self._fn, block, self._args, self._kwargs)


class OpStats:
    """Per-operator execution counters (parity: data/_internal/stats.py)."""

    def __init__(self, name: str):
        self.name = name
        self.blocks = 0
        self.wall_s = 0.0


class DatasetStats:
    def __init__(self):
        self.ops: List[OpStats] = []

    def add_op(self, name: str) -> OpStats:
        op = OpStats(name)
        self.ops.append(op)
        return op

    def summary(self) -> str:
        """Per-op SELF time: each _timed layer's gross time includes its
        whole upstream chain (pull-based pipeline), so op i's own cost is
        gross[i] - gross[i-1]."""
        lines = ["Dataset execution stats:"]
        prev = 0.0
        for op in self.ops:
            self_s = max(op.wall_s - prev, 0.0)
            prev = op.wall_s
            rate = op.blocks / self_s if self_s > 0 else float("inf")
            lines.append(
                f"  {op.name:<14s} blocks={op.blocks:<6d} "
                f"wall={self_s * 1000:8.1f}ms  ({rate:,.1f} blocks/s)"
            )
        return "\n".join(lines)


class StreamingExecutor:
    def __init__(self, max_tasks_in_flight: int = 8, preserve_order: bool = True):
        self.max_in_flight = max_tasks_in_flight
        self.preserve_order = preserve_order
        self._actor_pools: List[List[Any]] = []
        self.stats = DatasetStats()

    # -------------------------------------------------------------- execute
    def execute(self, ops: Sequence[Op]) -> Iterator[Any]:
        """Run the chain; yields ObjectRefs of output blocks as they become
        ready. Streaming: stage N+1 starts on a block as soon as stage N
        produced it."""
        import ray_tpu_torch

        try:
            stream: Iterator[Any] = iter(())
            for op in ops:
                if isinstance(op, ReadOp):
                    stream = self._read_stream(op)
                elif isinstance(op, FromRefsOp):
                    stream = iter(op.refs)
                elif isinstance(op, MapBatchesOp):
                    stream = self._map_stream(op, stream)
                elif isinstance(op, LimitOp):
                    stream = self._limit_stream(op, stream)
                elif isinstance(op, RechunkOp):
                    stream = self._rechunk_stream(op, stream)
                else:
                    raise TypeError(f"unknown operator {op!r}")
                stream = self._timed(
                    getattr(op, "name", type(op).__name__), stream
                )
            yield from stream
        finally:
            self._shutdown_pools()

    def _timed(self, name: str, stream: Iterator[Any]) -> Iterator[Any]:
        """Wrap a stage: time spent pulling from it + block count feed the
        per-op stats (Dataset.stats())."""
        import time as _time

        entry = self.stats.add_op(name)

        def gen():
            while True:
                t0 = _time.perf_counter()
                try:
                    ref = next(stream)
                except StopIteration:
                    return
                finally:
                    entry.wall_s += _time.perf_counter() - t0
                entry.blocks += 1
                yield ref

        return gen()

    # -------------------------------------------------------------- stages
    def _bounded(self, submit_iter: Iterator[Any],
                 max_in_flight: Optional[int] = None) -> Iterator[Any]:
        """Pull refs from submit_iter keeping <= max_in_flight outstanding
        (a PER-STAGE parameter — stages with their own capacity, like actor
        pools, pass it explicitly rather than mutating the executor-wide
        default, which concurrent stages observe); yield in submission order
        (preserve_order) or completion order."""
        import ray_tpu_torch

        limit = max_in_flight if max_in_flight is not None else self.max_in_flight
        inflight: List[Any] = []
        for ref in submit_iter:
            inflight.append(ref)
            while len(inflight) >= limit:
                if self.preserve_order:
                    yield inflight.pop(0)
                else:
                    done, _ = ray_tpu_torch.wait(inflight, num_returns=1)
                    inflight.remove(done[0])
                    yield done[0]
        yield from inflight

    def _read_stream(self, op: ReadOp) -> Iterator[Any]:
        import ray_tpu_torch

        run = ray_tpu_torch.remote(num_cpus=1)(_run_read_task)

        def submit():
            for task in op.read_tasks:
                yield run.remote(task)

        return self._bounded(submit())

    def _map_stream(self, op: MapBatchesOp, upstream: Iterator[Any]) -> Iterator[Any]:
        import ray_tpu_torch

        if isinstance(op.compute, ActorPoolStrategy):
            return self._map_stream_actors(op, upstream)

        run = ray_tpu_torch.remote(num_cpus=1)(_run_map_task)

        def submit():
            for block_ref in upstream:
                yield run.remote(op.fn, block_ref, op.fn_args, op.fn_kwargs)

        return self._bounded(submit())

    def _map_stream_actors(self, op: MapBatchesOp, upstream: Iterator[Any]) -> Iterator[Any]:
        import ray_tpu_torch

        strategy: ActorPoolStrategy = op.compute
        actor_cls = ray_tpu_torch.remote(
            num_cpus=1, num_gpus=strategy.num_gpus)(_MapActor)
        pool = [
            actor_cls.remote(op.fn, op.fn_args, op.fn_kwargs)
            for _ in range(strategy.size)
        ]
        self._actor_pools.append(pool)
        cap = strategy.size * strategy.max_tasks_in_flight_per_actor

        def submit():
            for i, block_ref in enumerate(upstream):
                actor = pool[i % strategy.size]
                yield actor.map_block.remote(block_ref)

        # the pool's own capacity bounds THIS stage only: passing it into
        # _bounded (instead of clobbering self.max_in_flight around a LAZY
        # generator, whose save/restore bracketed creation — not iteration —
        # so every concurrently-running stage observed the pool's cap)
        yield from self._bounded(
            submit(), max_in_flight=min(self.max_in_flight, cap) if cap
            else None,
        )

    def _limit_stream(self, op: LimitOp, upstream: Iterator[Any]) -> Iterator[Any]:
        """Truncate the stream after `limit` rows (fetches counts as it goes)."""
        import ray_tpu_torch

        remaining = op.limit
        for ref in upstream:
            if remaining <= 0:
                return
            block = ray_tpu_torch.get(ref)
            n = block_num_rows(block)
            if n <= remaining:
                remaining -= n
                yield ref
            else:
                from ray_tpu_torch.data.block import block_slice

                yield ray_tpu_torch.put(block_slice(block, 0, remaining))
                remaining = 0
                return

    def _rechunk_stream(self, op: RechunkOp, upstream: Iterator[Any]) -> Iterator[Any]:
        import ray_tpu_torch

        from ray_tpu_torch.data.block import block_concat, block_slice

        size = op.batch_size
        buf: List[Block] = []
        buffered = 0
        for ref in upstream:
            buf.append(ray_tpu_torch.get(ref))
            buffered += block_num_rows(buf[-1])
            while buffered >= size:
                merged = block_concat(buf)
                yield ray_tpu_torch.put(block_slice(merged, 0, size))
                rest = block_slice(merged, size, buffered)
                buf = [rest] if block_num_rows(rest) else []
                buffered -= size
        if buffered:
            yield ray_tpu_torch.put(block_concat(buf))

    def _shutdown_pools(self):
        import ray_tpu_torch

        for pool in self._actor_pools:
            for a in pool:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # noqa: BLE001
                    pass
        self._actor_pools.clear()


def _run_read_task(task) -> Block:
    return task()


def _run_map_task(fn, block: Block, fn_args, fn_kwargs) -> Block:
    import inspect

    if inspect.isclass(fn):
        fn = fn(*fn_args, **(fn_kwargs or {}))
        return _apply_fn(fn, block, (), {})
    return _apply_fn(fn, block, fn_args, fn_kwargs)

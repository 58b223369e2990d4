"""Batch iteration with the copy to the card overlapped with its consumer.

The port's copy of ray_tpu/data/iterator.py. Parity: data/iterator.py:234
(`iter_torch_batches`) — the accelerator-feeding edge of the Data layer.
Blocks come out of the shm store zero-copy where possible, and where the
reference calls `jax.device_put` a batch becomes torch tensors on
`device`:

- on a card, each column's rows are copied, slice by slice straight from
  the blocks (no concatenated host batch: one host copy a batch), into a
  pinned staging buffer that is reused (a pool per column, shape and
  dtype, so two columns of one batch never share a buffer; pinning a
  fresh buffer for every batch is a synchronous cudaHostAlloc of several
  ms), then copied with
  `.to(device, non_blocking=True)` on a copy stream made on the target
  device, and an event is recorded after the copy. A staging buffer is
  refilled only once its event has completed. On yield, the consumer's
  current stream waits on the event and each tensor is `record_stream`'d
  to it, so the caching allocator does not hand its memory out again
  while the consumer's kernels still read it;
- on the CPU (`device="cpu"`), CPU tensors, with no pinning.

`prefetch_batches` is the number of batches whose copies are in flight
ahead of the one yielded. A column that cannot become a tensor (strings,
objects) raises a TypeError naming it. With no device the batches stay
numpy, as the reference's do.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, block_concat, block_num_rows, block_slice


def _host_batches(
    block_refs: Iterator[Any], batch_size: int, drop_last: bool
) -> Iterator[Block]:
    """Assemble exact-size host batches from a stream of block refs."""
    for pieces in _host_pieces(block_refs, batch_size, drop_last):
        yield block_concat(pieces)


def _prefetched(items: Iterator[Any], put, depth: int) -> Iterator[Any]:
    """Double-buffering window: issue `put` (an async device transfer) for
    item N+1..N+depth while item N is being consumed."""
    window: collections.deque = collections.deque()
    for item in items:
        window.append(put(item))
        if len(window) >= depth:
            yield window.popleft()
    while window:
        yield window.popleft()


def _host_pieces(
    block_refs: Iterator[Any], batch_size: int, drop_last: bool
) -> Iterator[List[Block]]:
    """Exact-size batches, each as its pieces: consecutive row slices of
    the blocks (views). _host_batches concatenates them; the device path
    copies each piece straight into the batch's staging buffer, the one
    host copy a batch needs."""
    import ray_tpu_torch

    pieces: List[Block] = []
    buffered = 0
    for ref in block_refs:
        block = ray_tpu_torch.get(ref)
        n, start = block_num_rows(block), 0
        while start < n:
            take = min(n - start, batch_size - buffered)
            pieces.append(block_slice(block, start, start + take))
            buffered += take
            start += take
            if buffered == batch_size:
                yield pieces
                pieces, buffered = [], 0
    if buffered and not drop_last:
        yield pieces


def _column_dtype(name: str, arrays: List[np.ndarray]) -> np.dtype:
    """The dtype of a column's pieces joined (np.concatenate's), refused
    with a TypeError naming the column when torch has none for it
    (strings, objects, datetimes)."""
    dtype = np.result_type(*arrays)
    if dtype.kind not in "biufc":
        raise TypeError(
            f"column {name!r} of dtype {dtype} cannot become a tensor; "
            f"drop or encode it before iterating with a device")
    return dtype


class _Staging:
    """A pinned host buffer and the event recorded after the copy that
    last read it (None until its first copy)."""

    __slots__ = ("host", "event")

    def __init__(self, host):
        self.host = host
        self.event = None


class _DeviceFeed:
    """Copies host batches onto one device (module docstring).

    `put(pieces, lead)` starts the copy of one batch given as its pieces
    (consecutive row slices, _host_pieces) and returns its pending
    tensors, whose leading rows take the shape `lead` when given (a
    stack's (N, B)); `ready(pending)` hands them to the consumer's stream.
    Each pool keeps at most `buffers` staging buffers of one column, shape
    and dtype: the batches of the prefetch window and the one being
    yielded."""

    def __init__(self, device, buffers: int):
        import torch

        device = torch.device(device)
        self.cuda = device.type == "cuda"
        if self.cuda:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"iter_batches(device={str(device)!r}): no CUDA device "
                    f"here; pass device='cpu' for CPU tensors")
            # the calling thread's current device when no index is given:
            # a Train worker's loop thread has its rank's card current
            index = device.index if device.index is not None else (
                torch.cuda.current_device())
            device = torch.device("cuda", index)
            self.stream = torch.cuda.Stream(device=device)
        self.device = device
        self.buffers = buffers
        self._pools: Dict[tuple, List[_Staging]] = {}

    def _staging(self, name: str, shape: tuple, dtype: np.dtype) -> _Staging:
        """A free pinned buffer for column `name` of this shape and dtype:
        one whose last copy has completed, a new one while the pool is
        short, else the oldest, once its copy has completed."""
        import torch

        pool = self._pools.setdefault((name, shape, dtype.str), [])
        for s in pool:
            if s.event is None or s.event.query():
                pool.remove(s)
                pool.append(s)
                return s
        if len(pool) < self.buffers:
            host = torch.empty(shape, pin_memory=True,
                               dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
            pool.append(_Staging(host))
            return pool[-1]
        s = pool.pop(0)
        s.event.synchronize()
        pool.append(s)
        return s

    def put(self, pieces: List[Block], lead: Optional[tuple] = None):
        import torch

        columns = {k: [np.asarray(p[k]) for p in pieces] for k in pieces[0]}
        dtypes = {k: _column_dtype(k, cols) for k, cols in columns.items()}

        def shape_of(cols):
            rows = sum(len(c) for c in cols)
            return (lead or (rows,)) + cols[0].shape[1:], (rows,) + cols[0].shape[1:]

        if not self.cuda:
            # a copy, as on the card: blocks out of the shm store are
            # read-only views
            return {k: torch.from_numpy(np.concatenate(cols))
                    .reshape(shape_of(cols)[0]) for k, cols in columns.items()}, None
        staged = []
        for k, cols in columns.items():
            shape, rows_shape = shape_of(cols)
            s = self._staging(k, shape, dtypes[k])
            flat, at = s.host.numpy().reshape(rows_shape), 0
            for c in cols:
                np.copyto(flat[at:at + len(c)], c, casting="same_kind")
                at += len(c)
            staged.append((k, s))
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            out = {k: s.host.to(self.device, non_blocking=True)
                   for k, s in staged}
            event.record(self.stream)
        for _, s in staged:
            s.event = event
        return out, event

    def ready(self, pending) -> Dict[str, Any]:
        import torch

        out, event = pending
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        return out


def _to_device(pieces: Iterator[List[Block]], device, prefetch: int,
               lead: Optional[tuple] = None):
    """Each item of `pieces` (a batch as its pieces) as a dict of tensors
    on `device`, `prefetch` copies ahead."""
    depth = max(1, prefetch + 1)
    feed = _DeviceFeed(device, depth + 1)
    for pending in _prefetched(pieces, lambda p: feed.put(p, lead), depth):
        yield feed.ready(pending)


def iter_batches(
    block_refs: Iterator[Any],
    *,
    batch_size: int = 256,
    prefetch_batches: int = 1,
    drop_last: bool = False,
    device: Any = None,
    sharding: Optional[Callable[[Block], Block]] = None,
) -> Iterator[Dict[str, Any]]:
    """Yield dict-of-array batches: numpy with no `device`, else tensors
    on `device` (module docstring), `prefetch_batches` copies ahead of the
    one yielded.

    `sharding` takes the place of the reference's NamedSharding: a
    function of a host batch applied before the copy, e.g. a meshed
    train bundle's `local_batch` (this rank's rows and positions of a
    global batch), so only this rank's share crosses PCIe."""
    if device is not None and sharding is None:
        yield from _to_device(_host_pieces(block_refs, batch_size, drop_last),
                              device, prefetch_batches)
        return
    host_iter = _host_batches(block_refs, batch_size, drop_last)
    if sharding is not None:
        host_iter = map(sharding, host_iter)
    if device is None:
        yield from host_iter
        return
    yield from _to_device(([b] for b in host_iter), device, prefetch_batches)


def iter_stacked_batches(
    block_refs: Iterator[Any],
    *,
    batch_size: int,
    steps_per_stack: int,
    device: Any = None,
    sharding: Optional[Callable[[Block], Block]] = None,
    prefetch_stacks: int = 1,
) -> Iterator[Dict[str, Any]]:
    """Yield batches STACKED on a leading step axis ``[N, B, ...]`` — the
    delivery format of ``TrainStepBundle.multi_step_fn`` (N optimizer
    steps over pre-staged batches in one call).

    Each stack is assembled on the host and copied to `device` as
    iter_batches copies a batch, `prefetch_stacks` stacks ahead; with no
    `device` it stays numpy. `sharding` (iter_batches) is applied to each
    batch before it is stacked. A trailing partial stack is dropped: the
    step count of a stack is fixed. (The reference's `stacked_sharding`,
    a jax sharding of the whole stack, is `device` and `sharding` here.)"""
    if device is not None and sharding is None:
        # a stack is its N·B consecutive rows, staged straight from the
        # blocks and shaped [N, B, ...]
        yield from _to_device(
            _host_pieces(block_refs, batch_size * steps_per_stack, True),
            device, prefetch_stacks, lead=(steps_per_stack, batch_size))
        return
    host_iter = _host_batches(block_refs, batch_size, drop_last=True)
    if sharding is not None:
        host_iter = map(sharding, host_iter)

    def stacks():
        stack = []
        for batch in host_iter:
            stack.append(batch)
            if len(stack) == steps_per_stack:
                yield {
                    k: np.stack([b[k] for b in stack]) for k in stack[0]
                }
                stack = []

    if device is None:
        yield from stacks()
        return
    yield from _to_device(([s] for s in stacks()), device, prefetch_stacks)

"""Stream state shared by both backends + the user-facing ObjectRefGenerator.

The owner (the submitting process) keeps one :class:`StreamState` per live
stream. Producers report items into it — directly (local backend, same
process) or via the owner's ``stream_item`` RPC handler (cluster backend) —
and the consumer's :class:`ObjectRefGenerator` blocks on it for the next
index. Item *values* never pass through this object: they land in the
owner's object store under deterministic ids
(``ObjectID.for_task_return(task_id, index)``), so the generator can mint
each ``ObjectRef`` without a lookup.

Thread model: one named (sanitizer) condition per stream. Producers/report
paths touch it only with non-blocking mutations (safe from the io loop); the
only blocking waits are the consumer's ``next_index`` (a user thread) and
the producer's ``wait_credit`` (a producer/executor thread, never the io
loop).

The port's copy of ray_tpu/streaming/generator.py, with the owner's item
counter (``streaming_items_total``) and the backlog gauge of unconsumed
items (``streaming_owner_buffered_items``). The reference's config field
``streaming_max_inflight_items`` is the module constant
``MAX_INFLIGHT_ITEMS``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.refs import ObjectRef

# Un-acked item pushes a producing worker keeps in flight when the caller set
# no generator_backpressure_num_objects, and the owner's bound on pushed but
# unconsumed items: past it the owner spills an inline item to the shm store.
MAX_INFLIGHT_ITEMS = 64

# owner-buffer guard plane (shared by all streams in this process): live
# over-cap unwindowed streams by identity → buffered count; the gauge
# exports the MAX and drops to 0 once every backlog drains or closes
_backlog_lock = _san.make_lock("streaming.backlog")
_backlogged: dict = {}
_backlog_gauge = None
_items_counter = None


def _count_item() -> None:
    """Owner-side item-throughput series: one count per pushed item landing
    in this owner's store (both backends report through here). The
    time-series rate of this counter is the stream's items/s."""
    from ray_tpu_torch.core.config import _config

    if not _config.metrics_enabled:
        return
    global _items_counter
    if _items_counter is None:
        from ray_tpu_torch.util.metrics import Counter

        _items_counter = Counter(
            "streaming_items_total",
            "stream items reported to this owner",
        )
    _items_counter.inc(1.0)


def _update_backlog_gauge(state: "StreamState", buffered: int,
                          over_cap: bool) -> None:
    global _backlog_gauge
    with _backlog_lock:
        if over_cap:
            _backlogged[id(state)] = buffered
        else:
            _backlogged.pop(id(state), None)
        top = max(_backlogged.values(), default=0)
    if _backlog_gauge is None:
        from ray_tpu_torch.util.metrics import Gauge

        _backlog_gauge = Gauge(
            "streaming_owner_buffered_items",
            "unconsumed pushed items buffered owner-side by the most "
            "backlogged unwindowed stream",
        )
    _backlog_gauge.set(top)


class EndOfStream(Exception):
    """Typed end-of-stream marker (internal wire/state use; consumers see
    the idiomatic ``StopIteration`` / ``StopAsyncIteration``)."""


class StreamState:
    """Owner-side bookkeeping for one streaming generator invocation."""

    def __init__(
        self,
        task_id: TaskID,
        owner_addr: Optional[str] = None,
        window: Optional[int] = None,
        name: str = "stream",
        explicit_window: bool = False,
    ):
        self.task_id = task_id
        self.owner_addr = owner_addr
        self.window = int(window) if window else None
        self.name = name
        # False = the window is the implicit pipeline cap, not a user
        # backpressure request: the owner-buffer guard below watches these
        # streams (one-way notify pushes can briefly overrun the cap)
        self.explicit_window = explicit_window
        self._buffer_warned = False
        self._was_backlogged = False
        self._cond = _san.make_condition("streaming.state")
        self.count = 0            # items reported ready (max index + 1)
        self.consumed = 0         # items handed to the consumer
        self.total: Optional[int] = None   # set once the producer finished
        self.error: Optional[BaseException] = None  # stream-level failure
        self.closed = False
        self._on_close: Optional[Callable[["StreamState"], None]] = None
        self._close_fired = False
        # asyncio credit waiters: (next_index, future, loop). The owner's
        # stream_item handler awaits these instead of parking an executor
        # thread per backpressured stream; the consumer resolves them.
        self._credit_waiters: list = []
        # a worker's "blocked" context (core/worker_main.py): a consumer
        # inside a task that waits for an item frees its lease's CPU
        # meanwhile, which its producer may need; None in a driver
        self.blocked: Optional[Callable] = None

    # ------------------------------------------------------------- producer
    def report_item(self, index: int, failed: bool = False) -> None:
        """Item ``index``'s value (or error) is in the owner's store."""
        with self._cond:
            if index + 1 > self.count:
                self.count = index + 1
            buffered = self.count - self.consumed
            self._cond.notify_all()
        _count_item()
        self._guard_owner_buffer(buffered)

    def _guard_owner_buffer(self, buffered: int) -> None:
        """Owner-side guard for unconsumed pushed items: export how far the
        most backlogged stream's consumer is behind, and warn ONCE per
        stream when an unwindowed stream overruns ``MAX_INFLIGHT_ITEMS``
        (one-way notify pushes can run ahead of the sync-point credit
        check).

        Zero-cost for healthy streams: the gauge plane is touched only
        while over the cap, plus once on the way back under so the export
        recovers to the true maximum (not a stale last write)."""
        if self.explicit_window:
            return
        cap = MAX_INFLIGHT_ITEMS
        over = buffered > cap
        if not over and not self._was_backlogged:
            return
        self._was_backlogged = over
        _update_backlog_gauge(self, buffered, over)
        if over and not self._buffer_warned:
            self._buffer_warned = True
            import logging

            logging.getLogger(__name__).warning(
                "stream %r: %d unconsumed items buffered owner-side "
                "(MAX_INFLIGHT_ITEMS=%d) — consumer is falling "
                "behind; set generator_backpressure_num_objects to bound "
                "the producer", self.name, buffered, cap,
            )

    def finish(self, total: int) -> None:
        """Producer exhausted the generator after ``total`` items."""
        with self._cond:
            if self.total is None:
                self.total = total
            self._cond.notify_all()

    def fail(self, error: BaseException) -> None:
        """Producer died mid-stream: already-reported items stay consumable;
        the consumer's next unready item raises ``error``. Idempotent —
        the first failure wins (it names the root cause)."""
        with self._cond:
            if self.error is None:
                self.error = error
            self._release_credit_locked()
            self._cond.notify_all()

    def wait_credit(self, next_index: int, timeout: Optional[float] = None) -> bool:
        """Backpressure: block the producer until the consumer has drained
        enough that item ``next_index`` is within the in-flight window.
        Returns False when the stream is closed/failed (stop producing).
        (Same-process producers only — the owner's RPC handler uses the
        non-blocking :meth:`credit_event` instead.)"""
        if self.window is None:
            return not (self.closed or self.error is not None)
        with self._cond:
            self._cond.wait_for(
                lambda: (
                    self.closed
                    or self.error is not None
                    or next_index < self.consumed + self.window
                ),
                timeout,
            )
            return not (self.closed or self.error is not None)

    def credit_event(self, next_index: int):
        """Asyncio flavor of :meth:`wait_credit` for the owner's io loop:
        returns a future resolved once ``next_index`` enters the window (or
        the stream closes/fails). MUST be called from a running event loop;
        never blocks a thread per waiting stream."""
        import asyncio

        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._cond:
            if (
                self.window is None
                or self.closed
                or self.error is not None
                or next_index < self.consumed + self.window
            ):
                fut.set_result(None)  # on the loop thread: safe to resolve
            else:
                self._credit_waiters.append((next_index, fut, loop))
        return fut

    def _release_credit_locked(self) -> None:
        """Resolve satisfied asyncio credit waiters (caller holds _cond)."""
        if not self._credit_waiters:
            return
        still = []
        for next_index, fut, loop in self._credit_waiters:
            if (
                self.closed
                or self.error is not None
                or next_index < self.consumed + (self.window or 0)
            ):
                loop.call_soon_threadsafe(
                    lambda f=fut: f.done() or f.set_result(None)
                )
            else:
                still.append((next_index, fut, loop))
        self._credit_waiters[:] = still

    # ------------------------------------------------------------- consumer
    def _settled(self) -> bool:
        return (
            self.consumed < self.count
            or self.error is not None
            or (self.total is not None and self.consumed >= self.total)
        )

    def next_index(self, timeout: Optional[float] = None) -> int:
        """Block until the next item is ready and claim it. Raises
        ``StopIteration`` at a clean end, the stream error after the last
        reported item of a failed stream, ``GetTimeoutError`` on timeout.
        A wait inside a worker's task runs in its ``blocked`` context,
        entered outside the condition (its exit may wait for the worker's
        execution slot, which must not hold up the producers' reports)."""
        if self.blocked is not None and not self._settled():
            with self.blocked():
                return self._next_index(timeout)
        return self._next_index(timeout)

    def _next_index(self, timeout: Optional[float]) -> int:
        from ray_tpu_torch import exceptions as exc

        with self._cond:
            ok = self._cond.wait_for(self._settled, timeout)
            if not ok:
                raise exc.GetTimeoutError(
                    f"stream {self.name!r}: no item within {timeout}s "
                    f"(consumed {self.consumed}, ready {self.count})"
                )
            if self.consumed < self.count:
                i = self.consumed
                self.consumed += 1
                buffered = self.count - self.consumed
                self._release_credit_locked()
                self._cond.notify_all()  # credit for a blocked producer
                if self._was_backlogged:  # draining: let the gauge recover
                    self._guard_owner_buffer(buffered)
                return i
            if self.error is not None:
                raise self.error
            raise StopIteration

    # ------------------------------------------------------------ lifecycle
    def set_on_close(self, cb: Callable[["StreamState"], None]) -> None:
        self._on_close = cb

    def close(self) -> None:
        """Consumer is done (drained, errored out, or abandoned the
        generator): release any blocked producer, tell it to stop early,
        and let the backend reclaim unconsumed item objects."""
        with self._cond:
            if self._close_fired:
                return
            self._close_fired = True
            self.closed = True
            self._release_credit_locked()
            self._cond.notify_all()
        if self._was_backlogged:  # closed stream no longer counts as backlog
            self._was_backlogged = False
            _update_backlog_gauge(self, 0, False)
        cb = self._on_close
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - cleanup must not raise in GC
                pass


def as_item_iterator(result):
    """Adapt a producer's return value to a plain item iterator: sync
    generators pass through; async generators are driven on a private event
    loop (one item per run_until_complete); anything else returns None (the
    caller reports a typed error — ``num_returns="streaming"`` requires a
    generator)."""
    import inspect

    if inspect.isgenerator(result):
        return result
    if inspect.isasyncgen(result):
        return _AsyncGenAdapter(result)
    return None


class _AsyncGenAdapter:
    """Drive an async generator from a synchronous producer thread."""

    def __init__(self, agen):
        import asyncio

        self._agen = agen
        self._loop = asyncio.new_event_loop()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self._loop.run_until_complete(self._agen.__anext__())
        except StopAsyncIteration:
            self._loop.close()
            raise StopIteration from None

    def close(self):
        try:
            self._loop.run_until_complete(self._agen.aclose())
        except Exception:  # noqa: BLE001 - best-effort shutdown
            pass
        finally:
            if not self._loop.is_closed():
                self._loop.close()


_END = object()


class ObjectRefGenerator:
    """Caller-side iterator over a stream's per-item ``ObjectRef``\\ s.

    Supports ``for ref in gen`` (sync) and ``async for ref in gen``; each
    ref resolves with ``ray_tpu_torch.get(ref)``. Dropping the generator without
    draining closes the stream (the producer is released and told to stop).
    Not serializable: the stream is owned by the submitting process.
    """

    def __init__(self, state: StreamState):
        self._state = state

    # -------------------------------------------------------- sync protocol
    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self.next_ref(None)

    def next_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """Next item's ref, blocking up to ``timeout``. StopIteration at a
        clean end; the stream's typed error if the producer died."""
        st = self._state
        try:
            i = st.next_index(timeout)
        except StopIteration:
            st.close()
            raise
        except BaseException as e:
            from ray_tpu_torch import exceptions as exc

            if not isinstance(e, exc.GetTimeoutError):
                st.close()  # terminal failure: reclaim + stop the producer
            raise
        return ObjectRef(
            ObjectID.for_task_return(st.task_id, i),
            owner_addr=st.owner_addr,
            task_id=st.task_id,
        )

    # ------------------------------------------------------- async protocol
    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio

        loop = asyncio.get_running_loop()
        ref = await loop.run_in_executor(None, self._next_or_end)
        if ref is _END:
            raise StopAsyncIteration
        return ref

    def _next_or_end(self):
        # StopIteration cannot cross an executor/coroutine boundary
        try:
            return self.next_ref(None)
        except StopIteration:
            return _END

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._state.close()

    def __del__(self):
        try:
            self._state.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is not serializable: streams are owned by "
            "the submitting process (pass the item refs instead)"
        )

    def __repr__(self):
        st = self._state
        return (
            f"ObjectRefGenerator({st.name!r}, consumed={st.consumed}, "
            f"ready={st.count}, total={st.total})"
        )

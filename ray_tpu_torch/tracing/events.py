"""Per-process task-event buffer + trace context propagation.

Parity: src/ray/core_worker/task_event_buffer.h — a bounded per-process
buffer of task state transitions, flushed to the GCS in batches, dropping
(and counting) instead of blocking when full.

The port's copy of ray_tpu/tracing/events.py.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.config import _config

# compact WAL line encoder: separators + no circular check shave ~40% off
# json.dumps on the per-event hot path; default=str keeps arbitrary span
# args writable
_WAL_ENCODE = json.JSONEncoder(
    separators=(",", ":"), check_circular=False, default=str
).encode

# Typed lifecycle states, in causal order. Not every task visits every
# state: LEASED fires only when the grant hits the raylet (cached-lease
# reuse skips it), EXECUTED is the worker-side end of execution (same clock
# as RUNNING, so spans are accurate), FINISHED/FAILED are the owner-side
# terminal verdicts.
SUBMITTED = "SUBMITTED"
LEASED = "LEASED"
DISPATCHED = "DISPATCHED"
RUNNING = "RUNNING"
EXECUTED = "EXECUTED"
FINISHED = "FINISHED"
FAILED = "FAILED"
PROFILE = "PROFILE"  # user/framework span, not a lifecycle transition

LIFECYCLE_STATES = (
    SUBMITTED, LEASED, DISPATCHED, RUNNING, EXECUTED, FINISHED, FAILED,
)
TERMINAL_STATES = (FINISHED, FAILED)


# --------------------------------------------------------------- trace context
# Thread-local (task_id, trace_id) of the task executing on this thread.
# Workers set it around task execution so nested submissions inherit the
# parent task id and the request's trace id; serve routers mint a fresh
# trace id per request when none is active.
_ctx = threading.local()


def current_task_id() -> Optional[str]:
    return getattr(_ctx, "task_id", None)


def current_trace_id() -> Optional[str]:
    return getattr(_ctx, "trace_id", None)


def current_job_id() -> Optional[str]:
    return getattr(_ctx, "job_id", None)


def current_deadline() -> Optional[float]:
    """Absolute wall-clock deadline (time.time() epoch seconds) of the
    request executing on this thread, or None when none is set."""
    return getattr(_ctx, "deadline", None)


def remaining_time_s() -> Optional[float]:
    """Seconds left until the current request's deadline (may be <= 0 once
    expired), or None when no deadline is active. User code running inside
    a deadline-carrying task can cooperate: checkpoint, return a partial
    result, or stop early instead of burning time nobody will wait for."""
    d = getattr(_ctx, "deadline", None)
    if d is None:
        return None
    return d - time.time()


def new_trace_id() -> str:
    return uuid.uuid4().hex


@contextlib.contextmanager
def task_context(task_id: Optional[str], trace_id: Optional[str],
                 job_id: Optional[str] = None,
                 deadline: Optional[float] = None):
    """Execute a task frame: nested submissions see this task as parent,
    ride the same trace, inherit the job (per-job retention), and carry
    the request deadline (overload protection: nested calls never outlive
    their root request's budget)."""
    prev = (getattr(_ctx, "task_id", None), getattr(_ctx, "trace_id", None),
            getattr(_ctx, "job_id", None), getattr(_ctx, "deadline", None))
    _ctx.task_id = task_id
    if trace_id is not None:
        _ctx.trace_id = trace_id
    if job_id is not None:
        _ctx.job_id = job_id
    if deadline is not None:
        _ctx.deadline = deadline
    try:
        yield
    finally:
        (_ctx.task_id, _ctx.trace_id, _ctx.job_id, _ctx.deadline) = prev


@contextlib.contextmanager
def deadline_context(deadline: Optional[float]):
    """Pin an absolute request deadline on the current thread. The
    EARLIER of `deadline` and any already-active deadline wins — a nested
    deployment call can tighten its parent's budget, never extend it."""
    prev = getattr(_ctx, "deadline", None)
    if deadline is not None and prev is not None:
        deadline = min(deadline, prev)
    _ctx.deadline = deadline if deadline is not None else prev
    try:
        yield _ctx.deadline
    finally:
        _ctx.deadline = prev


@contextlib.contextmanager
def trace_context(trace_id: str):
    """Pin a trace id on the current thread (every submission inside the
    block carries it)."""
    prev = getattr(_ctx, "trace_id", None)
    _ctx.trace_id = trace_id
    try:
        yield trace_id
    finally:
        _ctx.trace_id = prev


@contextlib.contextmanager
def ensure_trace():
    """Yield the active trace id, minting one for the duration of the block
    when none is active (the serve entry points use this: a request arriving
    with no trace starts one; a nested call keeps the caller's)."""
    existing = getattr(_ctx, "trace_id", None)
    if existing is not None:
        yield existing
        return
    _ctx.trace_id = tid = new_trace_id()
    try:
        yield tid
    finally:
        _ctx.trace_id = None


# ------------------------------------------------------------------- sampling
def _sampled(trace_id: Optional[str], task_id: Optional[str]) -> bool:
    """Deterministic keep/drop: hash the trace id (whole requests sample
    together across every process) or the task id. Events with neither key
    are always kept (rare: ad-hoc spans outside any task)."""
    rate = _config.task_events_sample_rate
    if rate >= 1.0:
        return True
    key = trace_id or task_id
    if key is None:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(key.encode()) & 0xFFFF) < int(rate * 0x10000)


# ------------------------------------------------------------------ the buffer
class TaskEventBuffer:
    """Bounded, drop-counting per-process event buffer.

    Timestamps are wall-clock but strictly monotonic within the process
    (clamped), so a process's own events always sort in causal order even
    under clock adjustments.
    """

    def __init__(self, capacity: Optional[int] = None):
        self._lock = _san.make_lock("tracing.buffer")
        self._capacity = capacity or max(100, _config.task_events_buffer_size)
        self._events: deque = deque()
        self._dropped = 0          # cumulative, this process
        self._last_ts = 0.0
        # process identity defaults: events recorded without an explicit
        # node/worker (profile_span, serve/cgraph spans) are attributed to
        # THIS process, so the timeline renders them on the right row
        self._node_id: Optional[str] = None
        self._worker: Optional[str] = None
        # crash forensics WAL: when enabled (workers), every recorded event
        # is appended to a per-worker file BEFORE the periodic flush, so a
        # SIGKILL loses at most the event being written — the raylet
        # recovers the orphaned file into the aggregator (see
        # node_manager._recover_worker_wal)
        self._wal_path: Optional[str] = None
        self._wal_fd: Optional[int] = None

    def set_identity(self, node_id: Optional[str],
                     worker: Optional[str]) -> None:
        """Set this process's default node/worker attribution (called by
        the backend once its address is known)."""
        self._node_id = node_id
        self._worker = worker

    # ------------------------------------------------------------------- WAL
    def enable_wal(self, path: str) -> bool:
        """Append every subsequent event to ``path`` (JSON lines). O_APPEND
        writes of whole lines, no buffering: a torn final line at SIGKILL is
        tolerated by the reader."""
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        except OSError:
            return False
        with self._lock:
            self._wal_path = path
            self._wal_fd = fd
        return True

    def _wal_append_locked(self, e: dict) -> None:
        if self._wal_fd is None:
            return
        try:
            # None fields are dropped: readers use .get(), and smaller
            # lines keep the per-event cost down on the worker hot path
            os.write(self._wal_fd, (_WAL_ENCODE(
                {k: v for k, v in e.items() if v is not None}
            ) + "\n").encode())
        except OSError:
            # a full/st-gone disk must never break the hot path; drop the
            # WAL, the in-memory plane keeps working
            try:
                os.close(self._wal_fd)
            except OSError:
                pass
            self._wal_fd = None

    def wal_flushed(self) -> None:
        """The flush loop delivered a drain to the aggregator: shrink the
        WAL to exactly the still-unflushed events. Empty buffer (the common
        case — a flush usually drains everything) truncates in place; a
        non-empty buffer REWRITES the file from the in-memory events (an
        atomic tmp+rename, re-opened for appends), so a busy worker's WAL
        never grows past one buffer and crash recovery never replays events
        the aggregator already has."""
        with self._lock:
            if self._wal_fd is None:
                return
            try:
                if not self._events:
                    os.ftruncate(self._wal_fd, 0)
                    return
                tmp = self._wal_path + ".tmp"
                data = "".join(
                    _WAL_ENCODE(
                        {k: v for k, v in e.items() if v is not None}
                    ) + "\n"
                    for e in self._events
                ).encode()
                fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                             0o644)
                try:
                    os.write(fd, data)
                finally:
                    os.close(fd)
                os.replace(tmp, self._wal_path)
                # clear BEFORE close/reopen: if either fails, the stale
                # (closed) descriptor number must never be written again —
                # the OS reuses fd numbers, and a later append would
                # corrupt whatever file/socket inherited it
                fd_old, self._wal_fd = self._wal_fd, None
                os.close(fd_old)
                self._wal_fd = os.open(
                    self._wal_path, os.O_WRONLY | os.O_APPEND
                )
            except OSError:
                # a failed shrink only costs WAL compactness, never events
                pass

    # ------------------------------------------------------------- recording
    def enabled(self) -> bool:
        return _config.task_events_enabled

    def _now_locked(self) -> float:
        ts = time.time()
        if ts <= self._last_ts:
            ts = self._last_ts + 1e-6
        self._last_ts = ts
        return ts

    def record(
        self,
        *,
        task_id: Optional[str] = None,
        name: str = "",
        state: str = PROFILE,
        attempt: int = 0,
        parent_id: Optional[str] = None,
        actor_id: Optional[str] = None,
        node_id: Optional[str] = None,
        worker: Optional[str] = None,
        trace_id: Optional[str] = None,
        job_id: Optional[str] = None,
        component: str = "core",
        dur: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> bool:
        """Append one event; returns False when disabled, sampled out, or
        dropped at capacity."""
        if not _config.task_events_enabled:
            return False
        if not _sampled(trace_id, task_id):
            return False
        if job_id is None:
            job_id = current_job_id()
        with self._lock:
            if len(self._events) >= self._capacity:
                self._dropped += 1
                return False
            e: Dict[str, Any] = {
                "task_id": task_id,
                "name": name,
                "state": state,
                "ts": self._now_locked(),
                "attempt": attempt,
                "parent_id": parent_id,
                "actor_id": actor_id,
                "node_id": node_id if node_id is not None else self._node_id,
                "worker": worker if worker is not None else self._worker,
                "trace_id": trace_id,
                "job_id": job_id,
                "component": component,
            }
            if dur is not None:
                e["dur"] = dur
            if args:
                e["args"] = args
            self._events.append(e)
            self._wal_append_locked(e)
        return True

    def record_profile(self, name: str, dur: Optional[float] = None,
                       *, component: str = "user", node_id=None, worker=None,
                       args: Optional[dict] = None) -> bool:
        """Span/instant event tagged with the current task/trace context."""
        return self.record(
            task_id=current_task_id(), name=name, state=PROFILE,
            trace_id=current_trace_id(), component=component, dur=dur,
            node_id=node_id, worker=worker, args=args,
        )

    def note_dropped(self, n: int) -> None:
        """Count events lost outside the buffer (e.g. a flush whose GCS call
        failed after the drain)."""
        with self._lock:
            self._dropped += n

    # --------------------------------------------------------------- draining
    def drain(self, max_batch: int = 5000) -> Tuple[List[dict], int]:
        """Pop up to ``max_batch`` events plus the cumulative drop count.
        The drop count is CUMULATIVE (not a delta) so the aggregator can
        take a max per source — idempotent under re-reports."""
        out: List[dict] = []
        with self._lock:
            while self._events and len(out) < max_batch:
                out.append(self._events.popleft())
            dropped = self._dropped
        return out, dropped

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


_buffer: Optional[TaskEventBuffer] = None
_buffer_lock = _san.make_lock("tracing.buffers_global")


def get_buffer() -> TaskEventBuffer:
    """The process-wide buffer (one per process, like the metrics registry)."""
    global _buffer
    if _buffer is None:
        with _buffer_lock:
            if _buffer is None:
                _buffer = TaskEventBuffer()
    return _buffer


async def flush_task_events_loop(buf: TaskEventBuffer, get_conn,
                                 source: str, use_notify: bool = False):
    """Shared GCS flush loop (CoreWorker + raylet): drain → skip when there
    is no news (the drop counter is cumulative, so an unchanged value needs
    no re-report) → report; events that can't reach the GCS are counted as
    dropped, never retried (task_event_buffer.h semantics).

    ``get_conn`` returns the CURRENT GCS connection (reconnect loops swap
    it) or None; ``use_notify`` sends one-way frames for callers that must
    not block on the reply (the raylet).

    Drops are reported relative to this loop's START: the buffer is
    process-global and long-lived (a pytest driver outlives many clusters),
    and a fresh GCS must not be told about overflow that happened before it
    existed — ``dropped_at_source`` means "dropped during this cluster's
    lifetime". The reported value stays cumulative and monotonic, so the
    aggregator's per-source max() idempotence is unchanged."""
    import asyncio

    from ray_tpu_torch.core import rpc

    period = max(_config.task_events_flush_interval_ms, 100) / 1000
    baseline = buf.dropped
    last_dropped = 0
    while True:
        await asyncio.sleep(period)
        events, raw_dropped = buf.drain()
        dropped = max(0, raw_dropped - baseline)
        if not events and dropped == last_dropped:
            continue
        conn = get_conn()
        if conn is None or conn.closed:
            if events:
                buf.note_dropped(len(events))
            continue
        try:
            send = conn.notify if use_notify else conn.call
            await send("report_task_events", events=events, dropped=dropped,
                       source=source)
            last_dropped = dropped
            # flushed events are aggregated: the crash-forensics WAL only
            # needs to keep the unflushed tail
            buf.wal_flushed()
        except (rpc.RpcError, rpc.ConnectionLost):
            if events:
                buf.note_dropped(len(events))


def read_wal(path: str, max_bytes: Optional[int] = None) -> List[dict]:
    """Parse a worker's WAL file (JSON lines). Tolerates the torn final
    line a SIGKILL mid-write leaves behind; returns [] for a missing or
    empty file. With ``max_bytes``, only the file's final ``max_bytes``
    are decoded (the first, possibly mid-line, row is dropped) — the
    bounded read behind raylet→GCS WAL-tail shipping."""
    import json

    out: List[dict] = []
    try:
        with open(path, "rb") as f:
            if max_bytes is not None:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size > max_bytes:
                    f.seek(size - max_bytes)
                    f.readline()  # drop the partial first line
                else:
                    f.seek(0)
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue  # torn tail (or garbage): skip, keep the rest
                if isinstance(e, dict):
                    out.append(e)
    except OSError:
        return []
    return out


@contextlib.contextmanager
def profile_span(name: str, args: Optional[dict] = None,
                 component: str = "user"):
    """User API: time a block and record it as a span event attached to the
    current task and trace::

        with ray_tpu_torch.tracing.profile_span("tokenize"):
            ...
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        get_buffer().record_profile(
            name, dur=time.perf_counter() - t0, component=component,
            args=args,
        )

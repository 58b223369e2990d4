"""CoreWorker: per-process runtime embedded in drivers and workers.

Parity: src/ray/core_worker/core_worker.h:284 — task submission, ownership
(the submitting process owns returned refs and serves their values/locations:
reference_count.h:61), in-process memory store for small objects, shm object
store for large ones, direct worker-to-worker task push (direct_task_transport),
per-actor ordered submission queues (direct_actor_task_submitter).

Every CoreWorker runs an RPC server on the io-loop thread; owners serve
`get_object_info` from it, workers additionally accept `push_task` /
`push_actor_task` (handled in worker_main.WorkerAgent which subclasses this).

The port's copy of ray_tpu/core/core_worker.py: submission with cached
leases, pipelined (up to ``worker_max_tasks_in_flight`` specs in flight on
one leased worker, breadth first) with work stealing and the requeue bound,
ownership, distributed reference counting, borrows, lineage
reconstruction, pin renewal and the per-actor ordered submission window,
the owner side of streaming generators (``num_returns="streaming"``: items
pushed by the producing worker into this owner's store as they are
yielded), task events with trace, job and deadline propagation (tracing),
the shedding of expired deadlines, and the metrics flush. ``runtime_env``
is refused with NotImplementedError. ``lease_stats`` counts what the
pipeline did (the most specs one lease carried at once, and the specs
bounced back by a steal or the requeue bound). Across nodes it is the
reference's: a
remote read asks the local raylet to pull (chunked stream, native daemon or
rpc; the pull manager's ladder), then fetches straight from the holder,
then probes the GCS for a surviving copy, and only then gives
ObjectLostError, which leads to lineage reconstruction; lease requests carry
per-arg locality hints and follow spillback hops up to the reference's
bound of 8.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch import tracing
from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core import rpc, serialization, task_spec as ts
from ray_tpu_torch.core.config import _config
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store.shm_store import ShmClient
from ray_tpu_torch.core.options import RemoteOptions
from ray_tpu_torch.core.refs import ObjectRef

logger = logging.getLogger(__name__)


class _MemoryStore:
    """In-process store for small/owned objects (store_provider/memory_store)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._objects: Dict[ObjectID, Any] = {}   # oid -> ("val", bytes) | ("err", exc)
        self._events: Dict[ObjectID, asyncio.Event] = {}

    def _event(self, oid) -> asyncio.Event:
        ev = self._events.get(oid)
        if ev is None:
            # setdefault is GIL-atomic: user threads (put_value) and the io
            # loop (wait_for) race get-or-create here, and two distinct
            # Events for one oid would strand a no-timeout waiter forever
            ev = self._events.setdefault(oid, asyncio.Event())
        return ev

    def _wake(self, oid: ObjectID) -> None:
        # Wake ONLY when a waiter already created the event: the common
        # ray.put() has no waiter, and waking the io loop per put (one
        # call_soon_threadsafe syscall + a GIL bounce each) capped small
        # puts at ~800 ops/s in the microbenchmark. Writers store the
        # object BEFORE calling _wake, and wait_for re-checks the store
        # after creating its event, so the no-event fast path can't strand
        # a waiter (GIL-ordered dict operations).
        ev = self._events.get(oid)
        if ev is None:
            return
        if threading.current_thread().name != "ray-tpu-io":
            self._loop.call_soon_threadsafe(ev.set)
        else:
            ev.set()

    def put_value(self, oid: ObjectID, data):
        self._objects[oid] = ("val", data)
        self._wake(oid)

    def put_error(self, oid: ObjectID, error: BaseException):
        self._objects[oid] = ("err", error)
        self._wake(oid)

    def contains(self, oid: ObjectID) -> bool:
        return oid in self._objects

    def peek(self, oid: ObjectID):
        return self._objects.get(oid)

    async def wait_for(self, oid: ObjectID, timeout: Optional[float]):
        if oid not in self._objects:
            ev = self._event(oid)
            if oid not in self._objects:  # re-check: no-event-yet put race
                try:
                    await asyncio.wait_for(ev.wait(), timeout)
                except asyncio.TimeoutError:
                    raise exc.GetTimeoutError(
                        f"object {oid.hex()[:16]} not ready"
                    )
        return self._objects[oid]

    def delete(self, oid: ObjectID):
        self._objects.pop(oid, None)
        self._events.pop(oid, None)


@dataclass(eq=False)  # identity semantics: hashable for the pool's WeakSet,
class _LeaseEntry:    # and list.remove can never conflate two same-shaped leases
    """One cached worker lease (scheduling-key lease reuse).

    A lease admits up to ``worker_max_tasks_in_flight`` concurrent
    submissions (pipelined submission: the wire round trip of task N+1
    overlaps the worker-side execution of task N — without it, in-flight
    concurrency is capped at the number of leases).
    ``inflight`` counts submissions between acquire and release; ``pooled``
    mirrors membership in pool.idle (single source of truth for the list);
    ``dropped`` makes concurrent failure paths return the lease only once.
    ``gpu_ids`` are the cards the raylet gave the lease, which the worker
    makes its CUDA_VISIBLE_DEVICES.
    """

    raylet: Any
    raylet_addr: str
    lease_id: str
    worker_addr: str
    conn: Any
    last_used: float = 0.0
    inflight: int = 0
    pooled: bool = False
    dropped: bool = False
    # a requeue bounce sets this: don't pipeline MORE tasks onto this
    # worker (its current task is long/blocking) until the window passes;
    # taking it at inflight == 0 is always fine
    defer_pipeline_until: float = 0.0
    gpu_ids: Optional[List[str]] = None


class _LeasePool:
    """Per-scheduling-key lease state: idle entries + outstanding count."""

    def __init__(self):
        self.idle: List[_LeaseEntry] = []
        self.pending = 0  # unresolved lease REQUESTS only (rate-limit gate)
        self.backlog = 0  # submitters currently inside _acquire_lease
        self.batch_inflight = False  # one opportunistic batch request at a time
        self.last_kick = 0.0  # last backlog-sized batch request (cooldown)
        self.last_steal = 0.0  # work-stealing trigger cooldown
        self.error: Optional[BaseException] = None  # latest failed request
        from collections import deque

        self._waiters: "deque" = deque()
        # every live entry of this key, including full-window ones that left
        # pool.idle — the work-stealing trigger needs to see busy victims
        # (weak: an entry is alive while pool.idle or an in-flight
        # submission holds it)
        import weakref

        self.entries: "weakref.WeakSet" = weakref.WeakSet()

    def wake(self):
        """Wake exactly ONE waiter (a released entry serves one task; waking
        everyone is a thundering herd — profiled at ~10 spurious coroutine
        resumptions per task at 50 in flight)."""
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    def wake_all(self):
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)

    async def wait(self, timeout: float) -> bool:
        """Park until wake()/wake_all() or timeout. True = woken."""
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            return False


class CoreWorker:
    """Driver/worker shared runtime. Thread model: user threads call the
    public methods; all networking happens on the private io-loop thread."""

    def __init__(
        self,
        gcs_address: str,
        raylet_address: Optional[str],
        session: str,
        node_id: str,
        mode: str = "driver",
    ):
        self.worker_id = WorkerID.from_random()
        self.mode = mode
        self.session = session
        self.node_id = node_id
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.io = rpc.EventLoopThread(name="ray-tpu-io")
        self.memory_store = _MemoryStore(self.io.loop)
        self.shm = ShmClient(session)
        # ownership tables (reference_count.h:61 ownership model)
        self.locations: Dict[ObjectID, dict] = {}     # owned shm objects
        self.submitted_specs: Dict[TaskID, ts.TaskSpec] = {}  # lineage
        self._lease_pools: Dict[tuple, "_LeasePool"] = {}  # sched-key cache
        # oid → {"pending": tasks holding it as an arg, "borrowers": addrs}
        self._owned: Dict[bytes, dict] = {}
        self._task_arg_pins: Dict[TaskID, List[bytes]] = {}
        # actor id → its creation task: the constructor's args spilled to
        # the store stay pinned while the actor may still (re)start
        self._actor_creation_tasks: Dict[bytes, TaskID] = {}
        self._return_oid_task: Dict[bytes, TaskID] = {}
        self._task_live_returns: Dict[TaskID, int] = {}  # unfreed returns/task
        self._reported_borrows: set = set()           # borrower side
        self._reconstructing: Dict[bytes, asyncio.Event] = {}  # by task_id
        self._reconstruct_attempts: Dict[bytes, int] = {}      # by task_id
        # results granted to us as borrows, pinned by the outer return oid
        # until released (see _store_task_result / _maybe_free)
        self._granting_outers: Dict[bytes, set] = {}   # inner → outer keys
        self._granted_by_outer: Dict[bytes, set] = {}  # outer → inner keys
        self._granted_owner: Dict[bytes, str] = {}     # inner → owner addr
        self._early_borrow_releases: Dict[bytes, set] = {}  # release-before-add
        self._fn_cache: Dict[bytes, Any] = {}
        self._registered_fns: set = set()
        self._registered_blobs: Dict[bytes, bytes] = {}
        # callable identity → fn_id: skips re-cloudpickling the same function
        # on every submit (~0.2 ms/task — the reference exports a function
        # descriptor once, too). Weak keys so we never pin user callables.
        self._fn_id_by_callable = weakref.WeakKeyDictionary()
        self._actor_addr_cache: Dict[bytes, str] = {}
        self._actor_queues: Dict[bytes, "_ActorSubmitState"] = {}
        self._actor_conns: Dict[str, rpc.Connection] = {}
        self._worker_conns: Dict[str, rpc.Connection] = {}
        self._raylet_conns: Dict[str, rpc.Connection] = {}
        # owner-side metadata batching (dispatch-plane overhaul): object
        # location records, shm frees and borrow releases queue here and
        # flush in ONE rpc per (kind, target) after rpc_batch_flush_ms,
        # keeping the submit/free hot paths to pure list appends
        self._meta_batches: Dict[tuple, list] = {}
        self._meta_handle = None
        self._meta_tasks: set = set()
        self._bg_tasks: set = set()  # strong refs: see _hold_bg
        self._lease_req_seq = itertools.count(1)
        self._conn_locks: Dict[tuple, asyncio.Lock] = {}
        self.server: Optional[rpc.RpcServer] = None
        self.gcs: Optional[rpc.Connection] = None
        self.raylet: Optional[rpc.Connection] = None
        self.address: Optional[str] = None
        # observability: bounded per-process task-event buffer, flushed to
        # the GCS aggregator periodically (ray_tpu_torch/tracing/)
        self.events = tracing.get_buffer()
        # what the pipeline did: the most specs one lease carried at once,
        # and the specs a worker bounced back (stolen by an idle peer's
        # owner, or unstarted past worker_requeue_after_ms)
        self.lease_stats = {"max_inflight": 0, "stolen": 0, "requeued": 0}
        # driver: GCS-assigned job id; workers tag submissions with the
        # EXECUTING task's job instead (tracing.current_job_id())
        self.job_id: Optional[str] = None
        self._lock = _san.make_lock("core.worker")
        # actor lifecycle listeners fed by the GCS "actor" pubsub channel
        # (compiled graphs subscribe their participants here)
        self._actor_listeners: List[Any] = []
        # live streaming generators owned by this process, by task_id bytes
        # (workers push items into handle_stream_item; consumers iterate)
        self._streams: Dict[bytes, Any] = {}

    @staticmethod
    def _stamp_deadline_clocks(spec: ts.TaskSpec) -> None:
        """Deadline-carrying specs record the owner's wall AND monotonic
        clocks at submission, so a receiving host can re-anchor the
        deadline into its own clock domain (ts.effective_deadline) instead
        of trusting raw cross-host wall-clock comparison (NTP skew guard)."""
        if spec.deadline is None:
            return
        spec.deadline_minted_wall = time.time()
        spec.deadline_minted_mono = time.monotonic()

    def _shed_expired(self, spec: ts.TaskSpec) -> bool:
        """Owner-side admission: True when the spec's deadline has already
        passed — the caller sheds it typed instead of dispatching work
        whose client gave up."""
        if spec.deadline is None or time.time() < spec.deadline:
            return False
        from ray_tpu_torch.util.metrics import deadline_expired_counter

        c = deadline_expired_counter()
        if c is not None:
            c.inc(1.0, {"where": "owner"})
        return True

    def _deadline_error(self, spec: ts.TaskSpec) -> exc.DeadlineExceededError:
        return exc.DeadlineExceededError(
            f"task {spec.name} shed before dispatch: request deadline "
            f"exceeded by {time.time() - spec.deadline:.3f}s"
        )

    @staticmethod
    def _backoff(attempt: int, actor: bool = False) -> float:
        """Retry delay (util/backoff.py): task resubmits and lineage use the
        config's base, the actor path its restart-backoff base."""
        from ray_tpu_torch.util import backoff

        return backoff.delay(
            attempt, _config.actor_restart_backoff_s if actor else None
        )

    # ------------------------------------------------------------ lifecycle
    def connect(self):
        self.io.run(self._connect_async(), timeout=60)
        from ray_tpu_torch.core import refs as refs_mod

        refs_mod.set_on_zero_callback(self._on_local_refs_zero)
        return self

    async def _connect_async(self):
        self.server = rpc.RpcServer(self)
        await self.server.start()
        self.address = self.server.address
        # default attribution for spans recorded in this process
        # (profile_span) — puts them on this worker's timeline row
        self.events.set_identity(self.node_id, self.address)
        # generous retry window: daemons may still be importing (cold start on
        # a loaded host takes seconds)
        self.gcs = await rpc.connect(
            self.gcs_address, handler=self, name=f"{self.mode}->gcs",
            retries=150, retry_delay=0.2,
        )
        if self.raylet_address:
            self.raylet = await rpc.connect(
                self.raylet_address, handler=self, name=f"{self.mode}->raylet"
            )
        if self.mode == "driver":
            reply = await self.gcs.call("register_driver")
            if isinstance(reply, dict) and reply.get("job_id") is not None:
                self._job_num = reply["job_id"]  # for idempotent re-register
                self.job_id = f"{reply['job_id']:04x}"
            await self._subscribe_logs()
        for loop_coro in (
            self._gcs_watchdog(), self._lease_reaper_loop(),
            self._pin_renew_loop(),
            self._flush_task_events_loop(), self._metrics_flush_loop(),
        ):
            self._hold_bg(asyncio.ensure_future(loop_coro))

    async def _subscribe_logs(self):
        """Driver side of the log plane (reference: worker.print_logs over
        GCS pubsub): raylet log monitors publish worker log lines; echo them
        to this driver's stderr with a (source ip=...) prefix."""
        if not _config.log_to_driver:
            return
        self.gcs.on_push("logs", self._on_log_push)
        try:
            await self.gcs.call("subscribe", channels=["logs"])
        except (rpc.RpcError, rpc.ConnectionLost):
            pass

    def _on_log_push(self, batch: dict):
        import sys

        src = batch.get("source", "worker")
        for line in batch.get("lines", []):
            print(f"({src}) {line}", file=sys.stderr, flush=True)

    # ------------------------------------------------ actor lifecycle plane
    def add_actor_listener(self, cb) -> None:
        """Subscribe ``cb(actor_id_bytes, state, reason)`` to cluster-wide
        actor state transitions (GCS "actor" channel; the GCS publishes on
        every ready/failed/restarting/dead edge)."""
        with self._lock:
            first = not self._actor_listeners
            self._actor_listeners.append(cb)
        if first:
            try:
                self.io.run(self._subscribe_actor_events(), timeout=30)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass  # watchdog re-subscribes on reconnect

    def remove_actor_listener(self, cb) -> None:
        with self._lock:
            try:
                self._actor_listeners.remove(cb)
            except ValueError:
                pass

    async def _subscribe_actor_events(self):
        self.gcs.on_push("actor", self._on_actor_push)
        await self.gcs.call("subscribe", channels=["actor"])

    def _on_actor_push(self, info: dict):
        for cb in list(self._actor_listeners):
            try:
                cb(info["actor_id"], info["state"],
                   info.get("death_reason") or "")
            except Exception:  # noqa: BLE001 - listeners must not break io
                logger.exception("actor listener failed")

    async def _metrics_flush_loop(self):
        """Flush this process's metrics registry (util/metrics.py) to the
        GCS — covers user-defined Counters/Gauges/Histograms recorded in
        tasks/actors on workers, and in driver code."""
        from ray_tpu_torch.util import metrics as metrics_api

        period = max(_config.metrics_report_interval_ms, 100) / 1000
        source = f"{self.mode}-{self.worker_id.hex()[:12]}"
        while True:
            await asyncio.sleep(period)
            try:
                # wire counters aggregate cluster-wide as registry Counters
                rpc.publish_wire_counters()
                samples = metrics_api.get_registry().collect()
                if samples and self.gcs is not None and not self.gcs.closed:
                    await self.gcs.notify(
                        "report_metrics", source=source, samples=samples
                    )
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
            except Exception:  # noqa: BLE001
                logger.exception("metrics flush error")

    async def _gcs_watchdog(self):
        """Re-dial the GCS if it restarts (fault tolerance: the store-backed
        GCS comes back on the same address and we re-register)."""
        while True:
            await asyncio.sleep(1.0)
            if self.gcs is None or not self.gcs.closed:
                continue
            try:
                self.gcs = await rpc.connect(
                    self.gcs_address, handler=self,
                    name=f"{self.mode}->gcs", retries=5, retry_delay=0.5,
                )
                if self.mode == "driver":
                    # idempotent re-register: the driver KEEPS its job id
                    # (a second mint would split this driver's task history
                    # and retention across two jobs)
                    await self.gcs.call(
                        "register_driver",
                        job_id=getattr(self, "_job_num", None),
                    )
                    await self._subscribe_logs()
                if self._actor_listeners:
                    try:
                        await self._subscribe_actor_events()
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
                # belt-and-suspenders: the GCS WAL makes acknowledged
                # registrations durable, but one whose reply raced the
                # crash was never acknowledged — re-register everything we
                # know from cache so outstanding fn_ids stay resolvable
                # even against a WAL-disabled head
                for fn_id, blob in list(self._registered_blobs.items()):
                    try:
                        await self.gcs.call(
                            "register_function", fn_id=fn_id, blob=blob
                        )
                    except (rpc.RpcError, rpc.ConnectionLost):
                        break
                logger.warning("reconnected to GCS at %s", self.gcs_address)
                if _config.metrics_enabled:
                    from ray_tpu_torch.util.metrics import Counter

                    Counter(
                        "gcs_reconnects_total",
                        "successful re-dials of a restarted GCS",
                    ).inc(1.0)
            except rpc.ConnectionLost:
                pass

    def shutdown(self):
        from ray_tpu_torch.core import refs as refs_mod

        refs_mod.set_on_zero_callback(None)
        try:
            self.io.run(self._shutdown_async(), timeout=10)
        except Exception:  # noqa: BLE001
            pass
        self.io.stop()

    async def _shutdown_async(self):
        # drop queued metadata batches and let in-flight flushes settle —
        # a flush left pending here dies noisily when the loop closes
        if self._meta_handle is not None:
            self._meta_handle.cancel()
            self._meta_handle = None
        self._meta_batches.clear()
        if self._meta_tasks:
            for t in self._meta_tasks:
                t.cancel()
            await asyncio.gather(*self._meta_tasks, return_exceptions=True)
        for conn in (
            list(self._worker_conns.values())
            + list(self._actor_conns.values())
            + list(self._raylet_conns.values())
        ):
            await conn.close()
        if self.gcs:
            await self.gcs.close()
        if self.raylet:
            await self.raylet.close()
        if self.server:
            await self.server.close()
        # stop actor-queue consumers etc. so the loop closes cleanly
        me = asyncio.current_task()
        for t in asyncio.all_tasks():
            if t is not me:
                t.cancel()

    # ---------------------------------------------------------- owner RPCs
    async def handle_get_object_info(self, conn, oid_hex):
        """Serve an owned object to a remote consumer: inline value, error, or
        shm location. `pending` while the producing task still runs."""
        oid = ObjectID.from_hex(oid_hex)
        entry = self.memory_store.peek(oid)
        if entry is not None:
            kind, payload = entry
            if kind == "err":
                return {"error": cloudpickle.dumps(payload)}
            if payload is not None:  # None = marker: value lives in shm
                # large/zero-copy-stored values ride the response frame's
                # out-of-band segment table (memoryviews are not picklable
                # in-band anyway)
                if isinstance(payload, memoryview) or (
                        len(payload) >= _config.rpc_oob_threshold_bytes):
                    return {"inline": rpc.Oob(payload)}
                return {"inline": payload}
        loc = self.locations.get(oid)
        if loc is not None:
            return {"location": loc}
        return {"pending": True}

    def handle_ping(self, conn):
        return "pong"

    # ------------------------------------------------- streaming generators
    # Owner side of the push protocol (ray_tpu_torch/streaming/): the
    # executing worker reports each yielded item over the task's own
    # connection the moment it is produced — small values inline, large ones
    # as a shm location (the bytes ride the node object store, not this
    # RPC). With a backpressure window the response is withheld until the
    # consumer drains (the worker blocks in `yield` awaiting it).

    def _make_stream(self, task_id: TaskID, window, name: str):
        from ray_tpu_torch.streaming import StreamState, generator

        # no explicit window still bounds owner-side buffering: sync-point
        # replies (every sync carries this credit check) are withheld once
        # the producer runs MAX_INFLIGHT_ITEMS ahead, so a slow consumer
        # never materializes the whole stream in our memory store
        explicit = bool(window)
        window = window or generator.MAX_INFLIGHT_ITEMS
        state = StreamState(
            task_id, owner_addr=self.address, window=window, name=name,
            explicit_window=explicit,
        )
        state.set_on_close(self._close_stream)
        # a worker (worker_main.WorkerAgent) frees its lease's CPU while a
        # task of it waits for an item, as it does in a get
        state.blocked = getattr(self, "blocked", None)
        self._streams[task_id.binary()] = state
        return state

    def _close_stream(self, state) -> None:
        """Consumer closed/abandoned the generator: forget the stream and
        reclaim item objects it never claimed (claimed items free through
        normal ref counting). Reclaim goes through _maybe_free so shm
        copies free on the raylet and borrows granted through an item
        release at their owners."""
        self._streams.pop(state.task_id.binary(), None)

        def _gc():
            for i in range(state.consumed, state.count):
                oid = ObjectID.for_task_return(state.task_id, i)
                self.memory_store.delete(oid)
                self._maybe_free(oid.binary())

        try:
            self.io.loop.call_soon_threadsafe(_gc)
        except RuntimeError:  # loop already closed (shutdown)
            pass

    def _fail_stream(self, spec, error: BaseException) -> bool:
        """Fail the stream of a streaming spec (producer death / submission
        failure); no-op for ordinary tasks. Returns True when handled."""
        if not spec.streaming:
            return False
        state = self._streams.get(spec.task_id.binary())
        if state is not None:
            state.fail(error)
        self._unpin_task_args(spec.task_id)
        self._record_task_event(spec, "FAILED")
        return True

    async def handle_stream_item(self, conn, task_id_hex, index, kind,
                                 payload, sync=True):
        """A producing worker pushed stream item `index`. Store it, wake the
        consumer, and — on sync pushes (requests the producer awaits; one-way
        notifies pass sync=False) — hold the reply until the item is inside
        the consumer's window, blocking the producer in `yield`."""
        from ray_tpu_torch.streaming import generator

        key = bytes.fromhex(task_id_hex)
        state = self._streams.get(key)
        if state is None or state.closed:
            return {"closed": True}  # producer stops early
        oid = ObjectID.for_task_return(TaskID(key), index)
        self._own(oid)
        if kind == "inline":
            data = rpc.unwrap_oob(payload)
            if (self.raylet is not None
                    and index - state.consumed
                    >= generator.MAX_INFLIGHT_ITEMS):
                # overflow spill: an explicitly-windowed producer may run
                # far ahead of its consumer — unconsumed items past the
                # bound land in the shm store (restored through the
                # normal location path on consume) instead of growing the
                # owner heap without bound
                self._spill_stream_item(oid, data)
            else:
                self.memory_store.put_value(oid, data)
        elif kind == "location":
            self.locations[oid] = payload
            self.memory_store.put_value(oid, None)  # shm-location marker
        else:  # "error": the exact item whose production raised
            self.memory_store.put_error(oid, cloudpickle.loads(payload))
        state.report_item(index, failed=(kind == "error"))
        if sync:
            # await credit without parking a thread: the consumer's
            # next_index (or close/fail) resolves the future
            await state.credit_event(index + 1)
            if state.closed:
                return {"closed": True}
        return {"consumed": state.consumed}

    _m_stream_spills = None

    def _spill_stream_item(self, oid: ObjectID, data) -> None:
        """Write one overflowing stream item to the local shm store with a
        location marker; the consumer's get restores it transparently
        (locations → _read_location → local shm read) and the normal free
        path reclaims it."""
        self._put_shm(oid, data)  # shm write + location record + notify
        self.memory_store.put_value(oid, None)  # shm-location marker
        if _config.metrics_enabled:
            if CoreWorker._m_stream_spills is None:
                from ray_tpu_torch.util.metrics import Counter

                CoreWorker._m_stream_spills = Counter(
                    "streaming_spilled_items_total",
                    "overflowing stream items spilled to the shm store",
                )
            CoreWorker._m_stream_spills.inc(1.0)

    # ------------------------------------------------------------- put/get
    # tracing: put/get record "core.put"/"core.get" spans, but only for
    # operations that took >= _PROFILE_MIN_DUR_S — sub-millisecond hot-path
    # calls (inline-ready gets, tiny puts) stay span-free so tight get/put
    # loops don't flood the bounded event buffer.
    _PROFILE_MIN_DUR_S = 0.001

    def _put_one(self, value: Any) -> Tuple[ObjectRef, int]:
        """Shared body of put/put_batch: allocate, serialize, own, store."""
        oid = ObjectID.for_put(self.worker_id)
        data = serialization.serialize(value).to_bytes()
        ref = ObjectRef(oid, owner_addr=self.address)
        self._own(oid)
        if len(data) <= _config.max_direct_call_object_size:
            self.memory_store.put_value(oid, data)
        else:
            self._put_shm(oid, data)
        return ref, len(data)

    def put(self, value: Any) -> ObjectRef:
        t0 = time.perf_counter()
        ref, nbytes = self._put_one(value)
        dur = time.perf_counter() - t0
        if dur >= self._PROFILE_MIN_DUR_S and self.events.enabled():
            self.events.record_profile(
                "core.put", dur=dur, component="core",
                node_id=self.node_id, worker=self.address,
                args={"nbytes": nbytes},
            )
        return ref

    def put_batch(self, values: Sequence[Any]) -> List[ObjectRef]:
        """Batched ray.put: one pass, one profile span, shm location
        records coalesced into a single object_added_batch flush (the
        dispatch-plane metadata batching). Per-value work is already
        loop-wake-free for small objects (see _MemoryStore._wake)."""
        t0 = time.perf_counter()
        refs = []
        total = 0
        for value in values:
            ref, nbytes = self._put_one(value)
            total += nbytes
            refs.append(ref)
        dur = time.perf_counter() - t0
        if dur >= self._PROFILE_MIN_DUR_S and self.events.enabled():
            self.events.record_profile(
                "core.put_batch", dur=dur, component="core",
                node_id=self.node_id, worker=self.address,
                args={"num": len(refs), "nbytes": total},
            )
        return refs

    def _put_shm(self, oid: ObjectID, data: bytes):
        self.shm.put_bytes(oid, data)
        self.locations[oid] = {
            "session": self.session,
            "raylet_addr": self.raylet_address,
            "node_id": self.node_id,
            "nbytes": len(data),
        }
        if self.raylet:
            self._notify_object_added(oid, len(data))

    # --------------------------------------------------- metadata batching
    # Location records (object_added), shm frees and borrow releases are
    # bookkeeping, not results: they leave the submit path as queued items
    # and flush as one batched rpc per (kind, target) every
    # rpc_batch_flush_ms (parity: the reference batches location updates
    # and ref-count flushes off CoreWorker hot paths too).

    def _hold_bg(self, t: "asyncio.Task") -> "asyncio.Task":
        """Strong ref until done: a bare ensure_future result is GC-able
        mid-flight; a collected prefetch would leak pool.pending and pin
        batch_inflight True, gating that scheduling key's lease kicks
        forever."""
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return t

    def _notify_object_added(self, oid, nbytes) -> None:
        """Thread-safe: queue one location record for the local raylet."""
        self.io.call_batched(
            self._queue_meta, "object_added", None, (oid.hex(), nbytes)
        )

    def _queue_meta(self, kind: str, target: Optional[str], item) -> None:
        """io-loop only. Queue one metadata record for the next batch flush."""
        self._meta_batches.setdefault((kind, target), []).append(item)
        if self._meta_handle is None:
            self._meta_handle = self.io.loop.call_later(
                max(0.0, _config.rpc_batch_flush_ms) / 1000.0,
                self._flush_meta,
            )

    def _flush_meta(self) -> None:
        self._meta_handle = None
        batches, self._meta_batches = self._meta_batches, {}
        for (kind, target), items in batches.items():
            # strong ref until done: a bare ensure_future result is GC-able
            # mid-flight (same footgun Connection._spawn guards against)
            t = asyncio.ensure_future(self._send_meta(kind, target, items))
            self._meta_tasks.add(t)
            t.add_done_callback(self._meta_tasks.discard)

    async def _send_meta(self, kind: str, target: Optional[str], items) -> None:
        try:
            if kind == "object_added":
                raylet = self.raylet
                if raylet is not None and not raylet.closed:
                    await raylet.notify_batched(
                        "object_added_batch", entries=items
                    )
            elif kind == "free":
                conn = await self._conn_to(target, kind="raylet")
                if conn is not None:
                    await conn.call_batched(
                        "free_objects", oids_hex=items, timeout=30
                    )
            elif kind == "release_borrow":
                conn = await self._conn_to(target, kind="worker")
                if conn is not None:
                    await conn.call_batched(
                        "release_borrows", entries=items, timeout=30
                    )
        except (rpc.RpcError, rpc.ConnectionLost):
            pass
        except Exception:  # noqa: BLE001 - bookkeeping must never kill io
            logger.exception("metadata batch flush failed (%s)", kind)

    async def _pin_renew_loop(self) -> None:
        """Owner side of primary pinning: every renew interval, send a
        batched pin renewal DIRECTLY to each raylet holding a primary this
        worker owns live references to — one rpc per raylet per sweep,
        nothing on the put/get hot paths. Renewals deliberately do NOT ride
        the metadata batch plane: its fire-and-forget flush swallows
        RpcError/ConnectionLost, and for an otherwise-idle owner (a quiet
        driver holding pins, generating no other metadata traffic) a
        silently-dropped batch was a missed renewal with nothing behind it
        to paper over the gap — leases aged out under a live owner. Here
        each send is awaited with its own quick retry and a logged failure.
        When this process dies the renewals stop and the raylet-side
        leases expire, so pins can never wedge eviction."""
        period = max(0.2, _config.object_pin_renew_interval_s)
        while True:
            await asyncio.sleep(period)
            try:
                by_raylet: Dict[str, List[str]] = {}
                for oid, loc in list(self.locations.items()):
                    if oid.binary() not in self._owned:
                        continue
                    addr = (loc or {}).get("raylet_addr")
                    if addr:
                        by_raylet.setdefault(addr, []).append(oid.hex())
                for addr, entries in by_raylet.items():
                    await self._send_pin_renewals(addr, entries)
            except Exception:  # noqa: BLE001 - bookkeeping must never kill io
                logger.exception("pin renewal sweep failed")

    async def _send_pin_renewals(self, addr: str, entries: List[str]) -> None:
        """One awaited renewal batch to one raylet, with a single quick
        retry over a fresh connection (the common transient is a severed
        cached conn). A final failure is LOGGED — the leases survive until
        TTL, so the next sweep usually lands — never silently dropped."""
        for attempt in (0, 1):
            try:
                conn = await self._conn_to(addr, kind="raylet")
                if conn is None:
                    return
                await conn.notify_batched("pin_objects", entries=entries)
                return
            except (rpc.RpcError, rpc.ConnectionLost):
                if attempt:
                    logger.warning(
                        "pin renewal to %s failed twice; %d lease(s) ride "
                        "on the next sweep (TTL still covers them)",
                        addr, len(entries),
                    )
                else:
                    await asyncio.sleep(0.05)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        if not self.events.enabled():
            return self._get_untraced(refs, timeout)
        t0 = time.perf_counter()
        try:
            return self._get_untraced(refs, timeout)
        finally:
            dur = time.perf_counter() - t0
            if dur >= self._PROFILE_MIN_DUR_S:
                self.events.record_profile(
                    "core.get", dur=dur, component="core",
                    node_id=self.node_id, worker=self.address,
                    args={"num_refs": len(refs)},
                )

    def _get_untraced(self, refs: Sequence[ObjectRef],
                      timeout: Optional[float]) -> List[Any]:
        # Fast path: every ref already resolved INLINE in our memory store →
        # decode on the calling thread, skipping the io-loop round trip
        # (~0.5ms each under load). This is the hot shape of streaming
        # consumers (items were pushed before the consumer asked) and of
        # repeated gets on small ready results. Reading the store dict off
        # the loop thread is GIL-safe; entries are immutable once written.
        entries = []
        for r in refs:
            entry = self.memory_store.peek(r.id)
            if entry is None or (entry[0] == "val" and entry[1] is None):
                break  # missing, or a shm-location marker: slow path
            entries.append(entry)
        else:
            out = []
            for kind, payload in entries:
                if kind == "err":
                    raise (
                        payload.as_instanceof_cause()
                        if isinstance(payload, exc.TaskError)
                        else payload
                    )
                out.append(serialization.loads(payload))
            return out
        return self.io.run(
            self._get_async(list(refs), timeout),
            timeout=None if timeout is None else timeout + 30,
        )

    async def _get_async(self, refs: List[ObjectRef], timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            out.append(await self._get_one(ref, remaining))
        return out

    async def _get_one(self, ref: ObjectRef, timeout: Optional[float]):
        data = await self._fetch_serialized(ref, timeout)
        if isinstance(data, BaseException):
            raise (
                data.as_instanceof_cause()
                if isinstance(data, exc.TaskError)
                else data
            )
        return serialization.loads(data)

    async def _fetch_serialized(self, ref: ObjectRef, timeout: Optional[float]):
        """Returns serialized bytes/buffer or an exception instance."""
        oid = ref.id
        deadline = None if timeout is None else time.monotonic() + timeout
        # 1) owned shm objects (ray.put of large values records a location
        #    without touching the memory store)
        if oid in self.locations:
            data = await self._read_location(oid, self.locations[oid])
            return await self._maybe_reconstruct(ref, data, deadline)
        # 2) own memory store (inline values + pending task results). Checked
        #    BEFORE the shm probe: every owned object lands in the memory
        #    store or in `locations` (step 1), and a shm miss probe is an
        #    open(2) raising FileNotFoundError — ~46us per get on slow-syscall
        #    kernels, paid once per task result before this reorder.
        if self.memory_store.contains(oid) or ref.owner_addr in (None, self.address):
            return await self._fetch_from_memory_store(ref, oid, timeout, deadline)
        # 3) local shm store (results produced on this node by other workers,
        #    read by a borrower without an owner round trip)
        buf = self.shm.get(oid)
        if buf is not None:
            return buf.buffer
        # 4) ask the owner (borrower path)
        lost_notifies = 0
        while True:
            info = await self._ask_owner(ref)
            if info is None:
                return exc.ObjectLostError(oid, "owner unreachable")
            if "error" in info:
                return cloudpickle.loads(info["error"])
            if "inline" in info:
                return rpc.unwrap_oob(info["inline"])
            if "location" in info:
                data = await self._read_location(oid, info["location"])
                if not isinstance(data, exc.ObjectLostError):
                    return data
                # location is stale (node died): tell the owner so it can
                # lineage-reconstruct, then keep polling for the new copy
                lost_notifies += 1
                if lost_notifies > 3:
                    return data
                conn = await self._conn_to(ref.owner_addr, kind="worker")
                if conn is not None:
                    try:
                        await conn.call(
                            "object_lost", oid_hex=oid.hex(), timeout=30
                        )
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
                await asyncio.sleep(0.2)
            # pending — poll with backoff
            if deadline is not None and time.monotonic() > deadline:
                raise exc.GetTimeoutError(f"get timed out on {oid.hex()[:16]}")
            await asyncio.sleep(0.01)

    async def _fetch_from_memory_store(self, ref, oid, timeout, deadline):
        kind, payload = await self.memory_store.wait_for(oid, timeout)
        if kind == "err":
            return payload
        if payload is None:  # marker: result went to shm
            data = await self._read_location(oid, self.locations.get(oid))
            return await self._maybe_reconstruct(ref, data, deadline)
        return payload

    async def _maybe_reconstruct(self, ref: ObjectRef, data, deadline):
        """Owner-side: a location read failed → resubmit the creating task
        via lineage and re-fetch (object_recovery_manager.h:41)."""
        if not isinstance(data, exc.ObjectLostError):
            return data
        if not await self._reconstruct(ref):
            return data
        remaining = (
            None if deadline is None else max(0.0, deadline - time.monotonic())
        )
        return await self._fetch_serialized(ref, remaining)

    async def _ask_owner(self, ref: ObjectRef):
        conn = await self._conn_to(ref.owner_addr, kind="worker")
        if conn is None:
            return None
        try:
            return await conn.call("get_object_info", oid_hex=ref.id.hex(), timeout=30)
        except (rpc.RpcError, rpc.ConnectionLost):
            return None

    async def _read_location(self, oid: ObjectID, loc: Optional[dict],
                             _survivor_probe: bool = True):
        if loc is None:
            return exc.ObjectLostError(oid, "no location")
        if loc["session"] == self.session:
            buf = self.shm.get(oid)
            if buf is not None:
                return buf.buffer
        # remote node: ask local raylet to pull, then read locally. A failing
        # pull (source node dead, typed store-full refusal) must fall
        # through to the direct fetch and ultimately ObjectLostError →
        # lineage reconstruction, not raise. Timeouts scale with object
        # size (object_transfer_timeout_* knobs): a multi-GB object on a
        # slow link must not die to a fixed deadline mid-transfer.
        from ray_tpu_torch.core.object_store.chunk_transfer import transfer_timeout

        timeout = transfer_timeout(loc.get("nbytes"))
        if self.raylet is not None:
            try:
                reply = await self.raylet.call(
                    "pull_object",
                    oid_hex=oid.hex(),
                    source_addr=loc["raylet_addr"],
                    nbytes=loc.get("nbytes"),
                    priority="arg",
                    job_id=self.job_id or tracing.current_job_id(),
                    timeout=timeout + 30,
                )
            except (rpc.RpcError, rpc.ConnectionLost):
                reply = None
            ok = (reply.get("ok") if isinstance(reply, dict) else bool(reply))
            if ok:
                buf = self.shm.get(oid)
                if buf is not None:
                    return buf.buffer
        # last resort: fetch bytes straight from the remote raylet
        conn = await self._conn_to(loc["raylet_addr"], kind="raylet")
        if conn is not None:
            try:
                data = await conn.call(
                    "fetch_object", oid_hex=oid.hex(), timeout=timeout
                )
                if data is not None:
                    return rpc.unwrap_oob(data)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        # the recorded holder is gone: the GCS death path may have promoted
        # a surviving secondary (or adopted a spill file) — retry ONCE
        # against a survivor before falling back to lineage reconstruction
        if _survivor_probe:
            alt = await self._survivor_location(oid, loc.get("raylet_addr"))
            if alt is not None:
                if oid in self.locations:
                    self.locations[oid] = alt  # re-anchor for later gets
                return await self._read_location(oid, alt,
                                                 _survivor_probe=False)
        return exc.ObjectLostError(oid, "object unavailable on all nodes")

    async def _survivor_location(self, oid: ObjectID,
                                 failed_addr: Optional[str]):
        """Ask the GCS location table for a holder other than the one that
        just failed (dead-node recovery: secondary promotion / spill
        adoption re-registers survivors there)."""
        if self.gcs is None or self.gcs.closed:
            return None
        try:
            holders = await self.gcs.call(
                "object_locations", oid_hex=oid.hex(), timeout=10
            )
        except (rpc.RpcError, rpc.ConnectionLost):
            return None
        for h in holders or []:
            if h.get("address") and h["address"] != failed_addr:
                return {
                    "session": h.get("session"),
                    "raylet_addr": h["address"],
                    "node_id": h.get("node_id"),
                    "nbytes": h.get("nbytes"),
                }
        return None

    async def _conn_to(self, addr: Optional[str], kind: str):
        if addr is None:
            return None
        cache = self._raylet_conns if kind == "raylet" else self._worker_conns
        conn = cache.get(addr)
        if conn is not None and not conn.closed:
            return conn
        # serialize creation per address: concurrent pipelined sends must all
        # ride ONE connection — two connections to the same actor worker lose
        # the frame-order guarantee actor-call ordering depends on
        lock = self._conn_locks.setdefault((kind, addr), asyncio.Lock())
        async with lock:
            conn = cache.get(addr)
            if conn is not None and not conn.closed:
                return conn
            try:
                conn = await rpc.connect(
                    addr, handler=self, retries=3, name=f"->{addr}"
                )
            except rpc.ConnectionLost:
                return None
            cache[addr] = conn
            return conn

    def wait(
        self, refs, num_returns: int, timeout: Optional[float], fetch_local: bool
    ):
        return self.io.run(
            self._wait_async(list(refs), num_returns, timeout),
        )

    async def _wait_async(self, refs, num_returns, timeout):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while len(ready) < num_returns:
            still = []
            for ref in pending:
                if await self._is_ready(ref):
                    ready.append(ref)
                else:
                    still.append(ref)
            pending = still
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            # event-driven for locally-owned refs: their readiness always
            # lands in the memory store (value, shm marker, or error), so
            # wake on the first event. Borrowed refs (owned elsewhere) have
            # no local event source — they keep the coarse poll as a
            # fallback bound on the wait.
            owned = [
                r for r in pending
                if r.owner_addr in (None, self.address)
            ]
            if owned:
                waiters = [
                    asyncio.ensure_future(
                        self.memory_store._event(r.id).wait()
                    )
                    for r in owned
                ]
                step = 0.01 if len(owned) < len(pending) else 5.0
                if deadline is not None:
                    step = min(step, max(0.0, deadline - time.monotonic()))
                done, pend = await asyncio.wait(
                    waiters, timeout=step,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                for w in pend:
                    w.cancel()
            else:
                await asyncio.sleep(0.01)
        return ready, [r for r in refs if r not in ready]

    async def _is_ready(self, ref: ObjectRef) -> bool:
        if self.memory_store.contains(ref.id) or ref.id in self.locations:
            return True
        if self.shm.contains(ref.id):
            return True
        if ref.owner_addr and ref.owner_addr != self.address:
            info = await self._ask_owner(ref)
            return info is not None and "pending" not in info
        return False

    # ------------------------------------------------------- task submission
    def register_function(self, fn) -> bytes:
        try:
            cached = self._fn_id_by_callable.get(fn)
        except TypeError:  # unhashable/unweakrefable callable
            cached = None
        if cached is not None:
            return cached
        blob = _pickle_callable(fn)
        fn_id = ts.function_id(blob)
        if fn_id not in self._registered_fns:
            self.io.run(
                self._gcs_call_retrying(
                    "register_function", fn_id=fn_id, blob=blob
                )
            )
            self._registered_fns.add(fn_id)
            self._registered_blobs[fn_id] = blob
            self._fn_cache[fn_id] = fn
        try:
            self._fn_id_by_callable[fn] = fn_id
        except TypeError:
            pass
        return fn_id

    async def _gcs_call_retrying(self, method, attempts: int = 10, **kw):
        """GCS call that rides out a fault-tolerance restart window (the
        watchdog re-dials within ~1s). In-flight control-plane waiters —
        ``get_actor``, ``get_channel_endpoint``, function/kv registration —
        all funnel through here: a connection torn mid-call retries behind
        the standard jittered backoff policy and, if the head never comes
        back, fails TYPED (GcsUnavailableError) instead of leaking a raw
        ConnectionLost to the caller."""
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            try:
                return await self.gcs.call(method, **kw)
            except rpc.ConnectionLost as e:
                last = e
                if attempt < attempts:
                    await asyncio.sleep(self._backoff(attempt))
        raise exc.GcsUnavailableError(
            f"GCS at {self.gcs_address} unreachable across {attempts} "
            f"attempts of {method!r}"
        ) from last

    async def load_function(self, fn_id: bytes):
        fn = self._fn_cache.get(fn_id)
        if fn is None:
            blob = None
            for attempt in range(10):
                try:
                    blob = await self.gcs.call("get_function", fn_id=fn_id)
                    break
                except rpc.ConnectionLost:
                    # GCS restarting (fault tolerance): the watchdog re-dials
                    # within ~1s — a task landing in that window must not fail
                    await asyncio.sleep(0.5)
            if blob is None:
                raise exc.RayTpuError(f"function {fn_id.hex()} not in registry")
            fn = cloudpickle.loads(blob)
            self._fn_cache[fn_id] = fn
        return fn

    def submit_task(self, func, args, kwargs, options: RemoteOptions):
        _refuse_unported(options)
        fn_id = self.register_function(func)
        task_id = TaskID.from_random()
        enc_args, enc_kwargs = ts.encode_args(args, kwargs, self.put)
        pg_id, pg_index = _pg_fields(options)
        streaming = options.num_returns == "streaming"
        spec = ts.TaskSpec(
            task_id=task_id,
            name=getattr(func, "__name__", "task"),
            fn_id=fn_id,
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=0 if streaming else max(1, options.num_returns),
            resources=options.task_resources(),
            owner_addr=self.address,
            max_retries=(
                options.max_retries
                if options.max_retries is not None
                else _config.task_max_retries
            ),
            retry_exceptions=options.retry_exceptions,
            scheduling_strategy=options.scheduling_strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=pg_index,
            streaming=streaming,
            backpressure=options.generator_backpressure_num_objects,
            trace_id=tracing.current_trace_id(),
            parent_task_id=tracing.current_task_id(),
            job_id=self.job_id or tracing.current_job_id(),
            deadline=tracing.current_deadline(),
        )
        self._stamp_deadline_clocks(spec)
        self._pin_task_args(task_id, enc_args, enc_kwargs)
        self._record_task_event(spec, "SUBMITTED")
        if streaming:
            from ray_tpu_torch.streaming import ObjectRefGenerator

            # no lineage entry: a stream is never replayed (its items may
            # already be consumed), and no task-owned return would free it
            state = self._make_stream(task_id, spec.backpressure, spec.name)
            self.io.call_batched(self._submit_stream_and_track(spec, state))
            return ObjectRefGenerator(state)
        self.submitted_specs[task_id] = spec
        refs = spec.return_refs()
        for r in refs:
            self._own(r.id, task_id)
        # batched wake: a 50-in-flight submission burst from the driver
        # thread costs one self-pipe write, not 50
        self.io.call_batched(self._submit_and_track(spec, refs))
        return refs

    async def _submit_stream_and_track(self, spec: ts.TaskSpec, state):
        """Streaming twin of _submit_and_track. A worker crash retries only
        while nothing has been produced yet (items may already have been
        consumed — a silent re-run would replay them); afterwards the stream
        fails with the typed error and the consumer's next item raises."""
        attempts = 0
        while True:
            if self._shed_expired(spec):
                self._fail_stream(spec, self._deadline_error(spec))
                return
            try:
                result = await self._submit_once(spec)
                self._store_task_result(spec, [], result)
                return
            except exc.WorkerCrashedError as e:
                if state.count == 0 and not state.closed:
                    attempts += 1
                    if attempts <= spec.max_retries:
                        logger.warning(
                            "streaming task %s worker crashed before first "
                            "item; retry %d", spec.name, attempts,
                        )
                        spec.attempt = attempts
                        await asyncio.sleep(self._backoff(attempts))
                        continue
                self._fail_stream(spec, e)
                return
            except exc.RayTpuError as e:
                self._fail_stream(spec, e)
                return
            except Exception as e:  # noqa: BLE001 - protocol failure
                self._fail_stream(
                    spec, exc.RayTpuError(f"stream submission failed: {e!r}")
                )
                return

    async def _submit_and_track(self, spec: ts.TaskSpec, refs: List[ObjectRef]):
        attempts = 0
        while True:
            if self._shed_expired(spec):
                self._store_task_error(
                    refs, self._deadline_error(spec), spec=spec
                )
                return
            try:
                result = await self._submit_once(spec)
                self._store_task_result(spec, refs, result)
                return
            except exc.WorkerCrashedError as e:
                attempts += 1
                # max_retries counts SYSTEM failures (worker/node death), like
                # the reference's task retry semantics; user exceptions retry
                # only with retry_exceptions (worker-side)
                if attempts <= spec.max_retries:
                    logger.warning(
                        "task %s worker crashed; retry %d", spec.name, attempts
                    )
                    spec.attempt = attempts
                    # backoff (was: immediate re-dispatch — a dying node made
                    # every owner hammer the raylet in lockstep)
                    await asyncio.sleep(self._backoff(attempts))
                    continue
                self._store_task_error(refs, e, spec=spec)
                return
            except exc.RayTpuError as e:
                self._store_task_error(refs, e, spec=spec)
                return
            except Exception as e:  # noqa: BLE001 - protocol failure
                self._store_task_error(
                    refs, exc.RayTpuError(f"task submission failed: {e!r}"),
                    spec=spec,
                )
                return

    async def _ensure_raylet(self):
        """Driver-side: if the adopted raylet died (remote cluster, node
        loss), re-adopt a live one from the GCS node table — otherwise every
        subsequent submission (including lineage resubmissions) fails on the
        dead connection. Workers never re-adopt: they die with their raylet
        (worker_main watchdog)."""
        if (self.raylet is not None and not self.raylet.closed) \
                or self.mode != "driver" or self.gcs is None:
            return self.raylet
        nodes = await self.gcs.call("get_nodes", timeout=30) or []
        node = next(
            (n for n in nodes if n["Alive"] and n["NodeID"] == self.node_id),
            None,
        ) or next((n for n in nodes if n["Alive"]), None)
        if node is None:
            return self.raylet
        conn = await self._conn_to(node["NodeManagerAddress"], kind="raylet")
        if conn is None:
            return self.raylet
        self.raylet = conn
        self.raylet_address = node["NodeManagerAddress"]
        self.node_id = node["NodeID"]
        if node["Session"] != self.session:
            from ray_tpu_torch.core.object_store.shm_store import ShmClient

            self.session = node["Session"]
            self.shm = ShmClient(self.session)
        logger.warning(
            "re-adopted raylet %s (node %s)", self.raylet_address, self.node_id
        )
        return self.raylet

    # ------------------------------------------------- lease cache (tasks)
    # Parity: CoreWorkerDirectTaskSubmitter's SchedulingKey lease reuse
    # (direct_task_transport.h:40-72) — a leased worker keeps executing
    # tasks of the same scheduling key instead of a request_lease /
    # return_lease round trip per task. Idle leases return after a TTL so
    # cached capacity doesn't starve other keys/drivers.

    def _arg_hints(self, spec: ts.TaskSpec) -> Optional[list]:
        """Owner-known locations of the spec's by-reference args, largest
        first: ``[(oid_hex, nbytes, node_id)]``. Rides the lease request so
        the raylet can prefer the node already holding the bytes and
        prefetch the rest. Cached on the spec — retries re-send the same
        hints, and the scheduling key reads them too."""
        cached = getattr(spec, "_arg_hints", None)
        if cached:
            return cached
        hints = []
        for ref in spec.dependencies():
            loc = self.locations.get(ref.id)
            if loc and loc.get("node_id") and loc.get("nbytes"):
                hints.append((ref.id.hex(), int(loc["nbytes"]),
                              loc["node_id"]))
        hints.sort(key=lambda h: -h[1])
        hints = hints[:8] or None
        if hints:
            # cache only NON-empty hints: a pipelined submission computes
            # this before its producing task finished (no location yet) —
            # a cached None would blind every retry to the by-then-known
            # locations of its largest args
            spec._arg_hints = hints
        return hints

    def _sched_key(self, spec: ts.TaskSpec):
        # big-arg tasks get a locality domain in their key: cached-lease
        # reuse skips the raylet entirely, so without this a lease granted
        # for node-A data would silently serve node-B-data tasks and the
        # locality hints could never matter past the first grant
        hints = self._arg_hints(spec)
        locality_domain = (
            hints[0][2]
            if hints and hints[0][1] >= _config.pull_chunk_bytes
            else None
        )
        return (
            tuple(sorted(spec.resources.items())),
            spec.placement_group_id,
            spec.placement_group_bundle_index,
            repr(spec.scheduling_strategy),
            locality_domain,
        )

    def _lease_pool(self, key) -> "_LeasePool":
        pool = self._lease_pools.get(key)
        if pool is None:
            pool = self._lease_pools[key] = _LeasePool()
        return pool

    async def _submit_once(self, spec: ts.TaskSpec) -> dict:
        key = self._sched_key(spec)
        pool = self._lease_pool(key)
        while True:
            pool.backlog += 1
            try:
                entry = await self._acquire_lease(pool, spec)
            finally:
                pool.backlog -= 1
            self._record_task_event(
                spec, "DISPATCHED", worker=entry.worker_addr
            )
            try:
                # batched push: specs headed to the same worker connection in
                # the same loop tick share one multi-spec BATCH frame; the
                # spec rides the frame pickler (protocol-5), so large inline
                # args (Oob-wrapped in encode_args) go out-of-band, zero-copy
                result = await entry.conn.call_batched(
                    "push_task", spec=spec, gpu_ids=entry.gpu_ids,
                    timeout=None,
                )
            except rpc.ConnectionLost as e:
                await self._drop_lease(pool, entry)
                raise exc.WorkerCrashedError(str(e)) from e
            except BaseException:
                await self._drop_lease(pool, entry)
                raise
            finally:
                self._release_lease_slot(pool, entry)
            if isinstance(result, dict) and result.get("requeue"):
                # the worker couldn't START it within worker_requeue_after_ms
                # (long/blocking task holds the run slot), or an idle peer's
                # steal took it back: resubmit to another worker and stop
                # pipelining onto this one meanwhile
                self.lease_stats[
                    "stolen" if result.get("why") == "stolen" else "requeued"
                ] += 1
                entry.defer_pipeline_until = time.monotonic() + 1.0
                continue
            return result

    def _release_lease_slot(self, pool: "_LeasePool", entry: "_LeaseEntry"):
        """One pipelined submission settled: free its slot and re-pool the
        entry if the full window had taken it out of pool.idle."""
        entry.inflight -= 1
        entry.last_used = time.monotonic()
        if entry.conn is not None and entry.conn.closed:
            entry.dropped = True  # conn died: never hand this entry out again
        self._pool_entry(pool, entry)

    def _pool_entry(self, pool: "_LeasePool", entry: "_LeaseEntry") -> None:
        if not entry.dropped and not entry.pooled:
            entry.pooled = True
            pool.idle.append(entry)
        if not entry.dropped:
            pool.entries.add(entry)
            if entry.inflight == 0:
                # this worker just went fully idle: reclaim queued specs
                # stuck behind a busy peer so they run HERE instead of
                # waiting out worker_requeue_after_ms
                self._maybe_steal(pool, entry)
        pool.wake()

    def _maybe_steal(self, pool: "_LeasePool", idle_entry: "_LeaseEntry"):
        """Work stealing (owner-side trigger): an idle leased worker +
        a same-key peer with queued (inflight >= 2) specs means those specs
        are pointlessly serialized — ask the most-loaded peer to bounce its
        queued-but-not-started specs; each bounce resubmits through
        _submit_once and lands on the idle entry."""
        if not _config.worker_stealing_enabled:
            return
        now = time.monotonic()
        if now - pool.last_steal < 0.005:
            return
        victim = None
        for e in pool.entries:
            if (e is idle_entry or e.dropped or e.inflight < 2
                    or e.conn is None or e.conn.closed):
                continue
            if victim is None or e.inflight > victim.inflight:
                victim = e
        if victim is None:
            return
        pool.last_steal = now
        n = victim.inflight - 1  # leave the running task in place
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # not on the io loop (shutdown path): skip
            return
        self._hold_bg(loop.create_task(self._send_steal(victim, n)))

    async def _send_steal(self, victim: "_LeaseEntry", n: int):
        try:
            await victim.conn.notify("steal_tasks", n=n)
        except Exception:  # noqa: BLE001 - advisory; requeue timer backstops
            pass

    async def _acquire_lease(self, pool: "_LeasePool", spec) -> "_LeaseEntry":
        """Take an idle cached lease, or request a fresh one.

        Every in-flight lease request belongs to a submitter that is
        actively awaiting it — never a detached fetcher. (An earlier design
        used background fetchers feeding the pool; their ownerless requests
        outlived demand bursts, sat queued at the raylet, and FIFO grant
        order then starved other scheduling keys into cluster-wide livelock
        — caught by the shuffle tests.) Granted entries still land in the
        SHARED pool before being re-popped, so a grant arriving while a
        cached entry freed up serves whichever waiter is first.
        """
        depth = max(1, _config.worker_max_tasks_in_flight)
        while True:
            while pool.idle:
                # breadth first: the least-loaded leased worker takes the
                # next task (pipelining fills a second slot on a busy worker
                # only once every worker has one); pool.idle is O(#workers).
                # Entries a requeue bounce marked defer_pipeline_until are
                # skipped for PIPELINED placement (their running task is
                # long/blocking) but stay takeable at inflight == 0.
                now = time.monotonic()
                usable = [
                    e for e in pool.idle
                    if e.inflight == 0 or now >= e.defer_pipeline_until
                ]
                if not usable:
                    break  # only deferred busy workers: get a fresh lease
                entry = min(usable, key=lambda e: e.inflight)
                if entry.conn is None or entry.conn.closed:
                    pool.idle.remove(entry)
                    entry.pooled = False
                    await self._drop_lease(pool, entry)
                    continue
                if entry.inflight > 0:
                    # Pipelining onto a busy worker: fine for overlapping
                    # the wire, but it must not CAP parallelism — keep one
                    # lease request in flight so grants grow the pool to
                    # what the cluster can actually run.
                    self._kick_backlog_lease(pool, spec)
                entry.inflight += 1
                if entry.inflight > self.lease_stats["max_inflight"]:
                    self.lease_stats["max_inflight"] = entry.inflight
                if entry.inflight >= depth:
                    # window full: out of the pool until a slot frees
                    pool.idle.remove(entry)
                    entry.pooled = False
                return entry
            # Rate-limit UNRESOLVED requests only (matching the reference's
            # lease-request limiter): granted leases are unbounded, so
            # long-running same-shape tasks keep full cluster parallelism.
            if pool.pending >= _config.max_pending_lease_requests_per_scheduling_key:
                await pool.wait(timeout=0.5)
                continue
            # scheduling key with backlog: piggyback ONE batched lease
            # request for the other waiting submitters (count bounded by
            # the pending budget) so a 50-in-flight burst costs a handful
            # of request_lease RPCs instead of 50 sequential round trips
            budget = _config.max_pending_lease_requests_per_scheduling_key
            extra = min(pool.backlog - 1 - pool.pending, budget - pool.pending - 1)
            if extra > 0 and not pool.batch_inflight:
                pool.batch_inflight = True
                pool.pending += extra
                self._hold_bg(asyncio.ensure_future(
                    self._prefetch_leases(pool, spec, extra)
                ))
            if pool.pending > 0:
                # A request is already in flight for this key. Racing one
                # per waiter costs a request+cancel RPC pair at the raylet
                # on nearly every task once the cluster is saturated
                # (measured 0.92 frames/task at 50 in flight) — park
                # instead; a grant or a returned cached lease wakes us.
                # A timeout (lost requester, e.g. cancelled mid-await)
                # falls through to firing our own request.
                if await pool.wait(timeout=0.5):
                    continue
            # race a fresh lease request against a cached entry freeing up;
            # the loser is cleaned up (queued request → cancel RPC; grant
            # that slips through anyway → pooled for the next waiter)
            pool.pending += 1
            req_id = f"{self.worker_id.hex()[:12]}-{next(self._lease_req_seq)}"
            holder: Dict[str, Any] = {}
            req = asyncio.ensure_future(
                self._request_new_lease(spec, req_id=req_id, holder=holder)
            )
            retired = False
            while not req.done():
                waiter = asyncio.get_running_loop().create_future()
                pool._waiters.append(waiter)
                try:
                    await asyncio.wait(
                        {req, waiter}, return_when=asyncio.FIRST_COMPLETED
                    )
                except BaseException:
                    # cancelled mid-await: leaving pool.pending incremented
                    # forever would park every later submitter on the timeout
                    # path — hand the request to the background settler
                    # (cancel at the raylet, decrement pending, pool a raced
                    # grant)
                    self._hold_bg(asyncio.ensure_future(
                        self._settle_request(pool, req, req_id, holder)
                    ))
                    if not waiter.done():
                        waiter.cancel()
                    raise
                if not waiter.done():
                    waiter.cancel()
                if req.done():
                    break
                if pool.idle:
                    # a cached entry really freed: take it, retire our
                    # request
                    self._hold_bg(asyncio.ensure_future(
                        self._settle_request(pool, req, req_id, holder)
                    ))
                    retired = True
                    break
                # spurious wake (e.g. an all-backlogged batch request freeing
                # its pending budget via wake_all): nothing to pop, and our
                # standing request is the only demand signal the raylet — and
                # the autoscaler behind it — can see. Re-arm and keep waiting;
                # retiring here livelocked CPU-starved clusters (the canceled
                # request left zero queued demand, so nothing ever scaled).
            if retired:
                continue
            pool.pending -= 1
            pool.wake()  # a pending slot freed: let a gated waiter retry
            try:
                entry = req.result()
            except BaseException:
                pool.wake()
                raise
            if entry is None:  # canceled under us (shouldn't happen here)
                continue
            self._pool_entry(pool, entry)
            continue  # re-pop: usually our own grant, FIFO otherwise

    async def _settle_request(self, pool: "_LeasePool", req, req_id, holder):
        """Background cleanup for a lease request whose submitter was served
        by the cache first: cancel it at the raylet; if the grant already
        raced through, pool the entry (it will serve a waiter or TTL out)."""
        raylet = holder.get("raylet")
        if raylet is not None and not raylet.closed:
            try:
                await raylet.call("cancel_lease_request", req_id=req_id,
                                  timeout=30)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        try:
            entry = await req
        except BaseException:  # noqa: BLE001 - request failed: slot freed
            pool.pending -= 1
            pool.wake()
            return
        pool.pending -= 1
        if entry is None:      # canceled cleanly
            pool.wake()
            return
        self._pool_entry(pool, entry)


    def _kick_backlog_lease(self, pool: "_LeasePool", spec) -> None:
        """Fire-and-forget one batched lease request, sized to the key's
        backlog, when submissions are stacking onto busy workers and nothing
        is pending. Grants land in the shared pool (zero-inflight entries
        every later submitter prefers); `backlogged` replies just free the
        budget. The raylet drops non-granted batch demand (by design — see
        handle_request_lease_batch), so the cooldown re-poll is what keeps
        a standing demand signal at the raylet while a burst lasts: each
        kick also lets its dispatch tick spawn one more worker."""
        if pool.pending > 0 or pool.batch_inflight:
            return
        now = time.monotonic()
        if now - pool.last_kick < 0.01:
            return
        pool.last_kick = now
        budget = _config.max_pending_lease_requests_per_scheduling_key
        count = max(1, min(pool.backlog, budget))
        pool.batch_inflight = True
        pool.pending += count
        self._hold_bg(asyncio.ensure_future(self._prefetch_leases(pool, spec, count)))

    async def _prefetch_leases(self, pool: "_LeasePool", spec, count: int):
        """Opportunistic batched lease request (raylet request_lease_batch):
        one RPC asks for `count` leases on behalf of the scheduling key's
        backlog. Grants land in the shared idle pool and serve whichever
        submitter pops first; non-grant replies just free the budget (the
        authoritative single requests still drive spillback/infeasibility).
        """
        try:
            raylet = await self._ensure_raylet()
            if raylet is None or raylet.closed:
                return
            raylet_addr = self.raylet_address
            # hints ride the batch only for big-arg scheduling keys: there
            # the locality domain in the key makes every spec's largest
            # arg live on the SAME node, so one spec's hints represent the
            # whole batch; small-arg keys mix tasks with different arg
            # homes and a representative hint would mislead all of them
            hints = self._arg_hints(spec)
            if not (hints and hints[0][1] >= _config.pull_chunk_bytes):
                hints = None
            try:
                replies = await raylet.call(
                    "request_lease_batch",
                    resources=spec.resources,
                    count=count,
                    pg_id=spec.placement_group_id,
                    bundle_index=spec.placement_group_bundle_index,
                    arg_hints=hints,
                    timeout=None,
                )
            except (rpc.RpcError, rpc.ConnectionLost):
                return
            for reply in replies or []:
                if "granted" not in reply:
                    continue
                conn = await self._conn_to(reply["granted"], kind="worker")
                if conn is None:
                    try:
                        await raylet.call(
                            "return_lease", lease_id=reply["lease_id"],
                            timeout=10,
                        )
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
                    continue
                self._pool_entry(pool, _LeaseEntry(
                    raylet=raylet,
                    raylet_addr=raylet_addr,
                    lease_id=reply["lease_id"],
                    worker_addr=reply["granted"],
                    conn=conn,
                    last_used=time.monotonic(),
                    gpu_ids=reply.get("gpu_ids"),
                ))
        except Exception:  # noqa: BLE001 - prefetch must never fail a task
            logger.exception("lease prefetch failed")
        finally:
            pool.pending -= count
            pool.batch_inflight = False
            pool.wake_all()

    async def _drop_lease(self, pool, entry: "_LeaseEntry"):
        if entry.dropped:  # pipelined peers may all observe the same death
            pool.wake()
            return
        entry.dropped = True
        pool.entries.discard(entry)
        if entry.pooled:
            entry.pooled = False
            try:
                pool.idle.remove(entry)
            except ValueError:
                pass
        pool.wake()
        try:
            await entry.raylet.call(
                "return_lease", lease_id=entry.lease_id, timeout=10
            )
        except (rpc.RpcError, rpc.ConnectionLost):
            pass

    async def _request_new_lease(
        self, spec: ts.TaskSpec, req_id: Optional[str] = None,
        holder: Optional[dict] = None,
    ) -> Optional["_LeaseEntry"]:
        """holder (when given) is updated with the raylet conn currently
        holding the queued request, so a canceller can reach it."""
        raylet = await self._ensure_raylet()
        raylet_addr = self.raylet_address
        if spec.placement_group_id is not None:
            # route straight to a raylet holding the target bundle
            addr = await self._pg_node_addr(
                spec.placement_group_id, spec.placement_group_bundle_index
            )
            if addr is not None and addr != raylet_addr:
                conn = await self._conn_to(addr, kind="raylet")
                if conn is None:
                    raise exc.RayTpuError(f"placement-group node {addr} gone")
                raylet, raylet_addr = conn, addr
        for _hop in range(8):  # spillback chain bound
            if holder is not None:
                holder["raylet"] = raylet
            try:
                reply = await raylet.call(
                    "request_lease",
                    resources=spec.resources,
                    pg_id=spec.placement_group_id,
                    bundle_index=spec.placement_group_bundle_index,
                    req_id=req_id,
                    # tracing: the raylet records the LEASED event for the
                    # task that triggered this request (cached-lease reuse
                    # means later same-key tasks skip the raylet entirely)
                    task_id=spec.task_id.hex(),
                    task_name=spec.name,
                    trace_id=spec.trace_id,
                    # locality: where this task's by-ref args live, so the
                    # raylet can grant near the bytes / prefetch the rest
                    arg_hints=self._arg_hints(spec),
                    timeout=None,
                )
            except rpc.ConnectionLost as e:
                # raylet died mid-lease: retryable system failure (the retry
                # re-enters _submit_once, which re-adopts a live raylet)
                raise exc.WorkerCrashedError(
                    f"raylet {raylet_addr} lost during lease: {e}"
                ) from e
            if "canceled" in reply:
                return None
            if "granted" in reply:
                worker_addr = reply["granted"]
                conn = await self._conn_to(worker_addr, kind="worker")
                if conn is None:
                    try:
                        await raylet.call(
                            "return_lease", lease_id=reply["lease_id"],
                            timeout=10,
                        )
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
                    raise exc.WorkerCrashedError(
                        f"cannot reach worker {worker_addr}"
                    )
                return _LeaseEntry(
                    raylet=raylet,
                    raylet_addr=raylet_addr,
                    lease_id=reply["lease_id"],
                    worker_addr=worker_addr,
                    conn=conn,
                    last_used=time.monotonic(),
                    gpu_ids=reply.get("gpu_ids"),
                )
            if "spillback" in reply:
                raylet_addr = reply["spillback"]
                conn = await self._conn_to(raylet_addr, kind="raylet")
                if conn is None:
                    raise exc.RayTpuError(f"spillback target {raylet_addr} gone")
                raylet = conn
                continue
            raise exc.RayTpuError(
                f"task {spec.name} infeasible: {reply.get('reason')}"
            )
        raise exc.RayTpuError("spillback loop exceeded")

    async def _lease_reaper_loop(self):
        """Return leases idle past the TTL so cached workers free their
        resources for other scheduling keys / drivers. Expired leases of
        one raylet return in a single batched return_leases RPC."""
        ttl = _config.worker_lease_idle_ttl_ms / 1000
        while True:
            await asyncio.sleep(ttl / 2)
            now = time.monotonic()
            expired: Dict[int, tuple] = {}
            for pool in list(self._lease_pools.values()):
                for entry in list(pool.idle):
                    if now - entry.last_used > ttl and entry.inflight == 0:
                        pool.idle.remove(entry)
                        entry.pooled = False
                        entry.dropped = True  # a late release must not re-pool
                        pool.wake()
                        _, ids = expired.setdefault(
                            id(entry.raylet), (entry.raylet, [])
                        )
                        ids.append(entry.lease_id)
            for raylet, lease_ids in expired.values():
                try:
                    await raylet.call(
                        "return_leases", lease_ids=lease_ids, timeout=10
                    )
                except (rpc.RpcError, rpc.ConnectionLost):
                    pass

    async def _pg_node_addr(self, pg_id: bytes, bundle_index: int):
        info = await self.gcs.call("get_placement_group", pg_id=pg_id, timeout=30)
        if not info or not info.get("placement"):
            return None
        placement = info["placement"]
        node_id = placement[max(0, bundle_index)]
        view = await self.gcs.call("get_resource_view", timeout=30)
        node = view.get(node_id)
        return node["address"] if node else None

    def _store_task_result(self, spec, refs, result: dict):
        """result: {"results": [(kind, payload), ...]}
        kind: inline|location|error, or streamed (generator completion: the
        items were already pushed via handle_stream_item; the entry carries
        the final count so the consumer sees a typed end-of-stream)."""
        entries = result["results"]
        if spec.streaming:
            state = self._streams.get(spec.task_id.binary())
            for kind, payload in entries:
                if kind == "streamed" and state is not None:
                    state.finish(payload["total"])
                elif kind == "error" and state is not None:
                    state.fail(cloudpickle.loads(payload))
            entries = [e for e in entries if e[0] != "streamed"]
        for ref, (kind, payload) in zip(refs, entries):
            if kind == "inline":
                self.memory_store.put_value(ref.id, rpc.unwrap_oob(payload))
            elif kind == "location":
                self.locations[ref.id] = payload
                # marker so local waiters wake up and read the location
                self.memory_store.put_value(ref.id, None)
            elif kind == "error":
                err = cloudpickle.loads(payload)
                self.memory_store.put_error(ref.id, err)
        # borrows the executing worker announced in its reply register BEFORE
        # the arg pins drop, so a stored ref can't be freed in the gap
        for oid_hex, addr in result.get("borrows", []):
            self.handle_add_borrow(None, oid_hex, addr)
        # refs nested in the result: the worker pre-registered us as borrower
        # with each owner. Pin each to this task's return oids — we release
        # when the outer value is freed (or when a deserialized inner ref's
        # last local copy dies after that), see _maybe_free. Streaming
        # grants arrive as (oid_hex, owner, item_index) triples and pin to
        # the ITEM's oid instead; an item already freed (consumed + ref
        # dropped mid-stream, or reclaimed at close) can never re-surface
        # its nested refs, so an unpinned grant with no live local ref is
        # released right away — otherwise it would leak at its owner.
        granted = result.get("granted") or []
        if granted:
            from ray_tpu_torch.core import refs as refs_mod

            outer_keys = [r.id.binary() for r in refs]
            for entry in granted:
                if len(entry) == 3:  # streaming: pin to the item's object
                    oid_hex, owner_addr, item_index = entry
                    item_key = ObjectID.for_task_return(
                        spec.task_id, item_index
                    ).binary()
                    pins = [item_key] if item_key in self._owned else []
                else:
                    oid_hex, owner_addr = entry
                    pins = outer_keys
                key = ObjectID.from_hex(oid_hex).binary()
                if self._is_owner(owner_addr):
                    continue
                if not pins and refs_mod.local_ref_count(key) == 0:
                    self._queue_meta(
                        "release_borrow", owner_addr, (oid_hex, self.address)
                    )
                    continue
                self._reported_borrows.add(key)
                self._granted_owner[key] = owner_addr
                self._granting_outers.setdefault(key, set()).update(pins)
                for ok in pins:
                    self._granted_by_outer.setdefault(ok, set()).add(key)
        self._unpin_task_args(spec.task_id)
        failed = any(kind == "error" for kind, _ in entries) or any(
            kind == "streamed" and payload.get("error")
            for kind, payload in result["results"]
        )
        self._record_task_event(spec, "FAILED" if failed else "FINISHED")

    def _store_task_error(self, refs, error: BaseException, spec=None):
        if spec is not None and self._fail_stream(spec, error):
            return  # streaming: the error surfaces on the consumer's next item
        for ref in refs:
            self.memory_store.put_error(ref.id, error)
        if refs:
            self._unpin_task_args(refs[0].task_id)
        if spec is not None:
            self._record_task_event(spec, "FAILED")

    # ---------------------------------------------------------- task events
    def _record_task_event(self, spec, state: str, worker: Optional[str] = None,
                           args: Optional[dict] = None) -> None:
        self.events.record(
            task_id=spec.task_id.hex(),
            name=spec.name,
            state=state,
            attempt=getattr(spec, "attempt", 0),
            parent_id=getattr(spec, "parent_task_id", None),
            actor_id=spec.actor_id.hex() if spec.actor_id else None,
            node_id=self.node_id,
            worker=worker or self.address,
            trace_id=getattr(spec, "trace_id", None),
            job_id=getattr(spec, "job_id", None),
            args=args,
        )

    async def _flush_task_events_loop(self):
        await tracing.events.flush_task_events_loop(
            self.events, lambda: self.gcs,
            source=f"{self.mode}-{self.worker_id.hex()[:12]}",
        )

    # ----------------------------------------------- distributed refcounting
    # Owner-based (reference_count.h:61): the submitting/putting process owns
    # each object and frees it cluster-wide when (a) no live ObjectRef in the
    # owner process, (b) no pending task holds it as an argument, and (c) no
    # borrower process has announced live refs. Borrowers (processes that
    # deserialized the ref) announce via the task reply ("borrows") or an
    # add_borrow RPC and release on their local zero-crossing.

    def _is_owner(self, owner_addr: Optional[str]) -> bool:
        return owner_addr is None or owner_addr == self.address

    def _own(self, oid: ObjectID, task_id: Optional[TaskID] = None) -> None:
        self._owned.setdefault(oid.binary(), {"pending": 0, "borrowers": set()})
        if task_id is not None:
            # _own runs on user threads, the free path on the io loop: the
            # lock (plus the per-task live-return COUNT, instead of a scan
            # over this dict) keeps _maybe_free from iterating a dict a
            # submitting thread is growing
            with self._lock:
                self._return_oid_task[oid.binary()] = task_id
                self._task_live_returns[task_id] = (
                    self._task_live_returns.get(task_id, 0) + 1
                )

    def _pin_task_args(self, task_id: TaskID, enc_args, enc_kwargs) -> None:
        pins: List[bytes] = []
        for t, v in list(enc_args) + list(enc_kwargs.values()):
            if t == ts.ARG_REF and self._is_owner(v.owner_addr):
                entry = self._owned.get(v.id.binary())
                if entry is not None:
                    entry["pending"] += 1
                    pins.append(v.id.binary())
        if pins:
            self._task_arg_pins[task_id] = pins

    def _unpin_task_args(self, task_id: Optional[TaskID]) -> None:
        if task_id is None:
            return
        for key in self._task_arg_pins.pop(task_id, []):
            entry = self._owned.get(key)
            if entry is not None:
                entry["pending"] -= 1
                self._maybe_free(key)

    def _on_local_refs_zero(self, oid, owner_addr, task_id) -> None:
        """GC callback (arbitrary thread): last local ObjectRef died."""
        try:
            if self._is_owner(owner_addr):
                # batched wake (io.call_batched): a gc sweep dropping N refs
                # costs one self-pipe write, not N — the per-ref
                # call_soon_threadsafe here was 75% of small-put time
                self.io.call_batched(self._maybe_free, oid.binary())
            elif oid.binary() in self._reported_borrows:
                if self._granting_outers.get(oid.binary()):
                    # an outer result value still pins this borrow: a later
                    # get() could re-materialize the ref, so release only
                    # when the outer itself is freed (_maybe_free)
                    return
                self._reported_borrows.discard(oid.binary())
                self._granted_owner.pop(oid.binary(), None)
                self.io.call_batched(
                    self._queue_meta, "release_borrow", owner_addr,
                    (oid.hex(), self.address),
                )
        except Exception:  # noqa: BLE001 - shutdown
            pass

    async def _notify_owner(self, owner_addr, method, **payload):
        conn = await self._conn_to(owner_addr, kind="worker")
        if conn is not None:
            try:
                await conn.call(method, timeout=30, **payload)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass

    def _maybe_free(self, key: bytes) -> None:
        from ray_tpu_torch.core import refs as refs_mod

        entry = self._owned.get(key)
        if entry is None:
            return
        if (refs_mod.local_ref_count(key) > 0 or entry["pending"] > 0
                or entry["borrowers"]):
            return
        self._owned.pop(key, None)
        self._early_borrow_releases.pop(key, None)
        oid = ObjectID(key)
        self.memory_store.delete(oid)
        loc = self.locations.pop(oid, None)
        addrs = {a for a in (
            loc.get("raylet_addr") if loc else None, self.raylet_address
        ) if a}
        for addr in addrs:  # frees flush in per-raylet batches off this path
            self._queue_meta("free", addr, oid.hex())
        # borrows granted through this (outer) result value: the outer no
        # longer pins them — release any with no other pin and no live ref
        for inner in self._granted_by_outer.pop(key, ()):
            outs = self._granting_outers.get(inner)
            if outs is not None:
                outs.discard(key)
                if outs:
                    continue
                self._granting_outers.pop(inner, None)
            if (refs_mod.local_ref_count(inner) == 0
                    and inner in self._reported_borrows):
                self._reported_borrows.discard(inner)
                owner = self._granted_owner.pop(inner, None)
                if owner:
                    self._queue_meta(
                        "release_borrow", owner,
                        (ObjectID(inner).hex(), self.address),
                    )
        # lineage cleanup: once every return of a task is freed, its spec is
        # no longer needed for reconstruction
        with self._lock:
            tid = self._return_oid_task.pop(key, None)
            last = False
            if tid is not None:
                n = self._task_live_returns.get(tid, 0) - 1
                if n <= 0:
                    self._task_live_returns.pop(tid, None)
                    last = True
                else:
                    self._task_live_returns[tid] = n
        if last:
            self.submitted_specs.pop(tid, None)
            self._task_arg_pins.pop(tid, None)

    # owner-side borrow bookkeeping.
    # A borrower's release (its own connection) can arrive BEFORE the add
    # that rides a task reply on a different connection — the borrowing
    # worker's ref dies on the executor thread the instant the task frame
    # exits, racing the reply write. An early release is remembered and
    # cancels the matching add when it lands, else the borrower sticks
    # forever and the object leaks.
    def handle_add_borrow(self, conn, oid_hex, addr):
        key = ObjectID.from_hex(oid_hex).binary()
        early = self._early_borrow_releases.get(key)
        if early is not None and addr in early:
            early.discard(addr)
            if not early:
                self._early_borrow_releases.pop(key, None)
            return True  # add + earlier release cancel out
        entry = self._owned.get(key)
        if entry is not None:
            entry["borrowers"].add(addr)
        return True

    def handle_release_borrow(self, conn, oid_hex, addr):
        key = ObjectID.from_hex(oid_hex).binary()
        entry = self._owned.get(key)
        if entry is not None and addr in entry["borrowers"]:
            entry["borrowers"].discard(addr)
            self._maybe_free(key)
        elif entry is not None:
            self._early_borrow_releases.setdefault(key, set()).add(addr)
        return True

    def handle_release_borrows(self, conn, entries):
        """Batched release_borrow: borrowers flush their zero-crossings in
        groups off the GC path (dispatch-plane batching)."""
        for oid_hex, addr in entries:
            self.handle_release_borrow(conn, oid_hex, addr)
        return True

    def report_new_borrows(self) -> List[tuple]:
        """Borrower side: oids deserialized here, still alive, not yet
        announced. Returns [(oid_hex, owner_addr)] and marks them reported."""
        from ray_tpu_torch.core import refs as refs_mod

        out = []
        for key, owner_addr in refs_mod.live_refs().items():
            if owner_addr is None or self._is_owner(owner_addr):
                continue
            if key in self._reported_borrows:
                continue
            self._reported_borrows.add(key)
            out.append((ObjectID(key).hex(), owner_addr))
        return out

    # ------------------------------------------------ lineage reconstruction
    async def _reconstruct(self, ref: ObjectRef) -> bool:
        """Resubmit the task that produced a lost owned object (parity:
        TaskManager resubmission task_manager.h:164 + ObjectRecoveryManager).
        Returns True if a resubmission completed."""
        spec = self.submitted_specs.get(ref.task_id) if ref.task_id else None
        if spec is None or spec.actor_id is not None:
            return False
        key = spec.task_id.binary()
        ev = self._reconstructing.get(key)
        if ev is not None:
            await ev.wait()
            return True
        # bounded: each lineage task resubmits at most max(1, max_retries)
        # times total, mirroring the reference's resubmission cap — without
        # this a repeatedly-lost object loops owner-side reconstruction
        # forever on a no-timeout get
        attempts = self._reconstruct_attempts.get(key, 0)
        if attempts >= max(1, spec.max_retries):
            return False
        self._reconstruct_attempts[key] = attempts + 1
        ev = asyncio.Event()
        self._reconstructing[key] = ev
        try:
            logger.warning(
                "reconstructing lost object(s) of task %s via lineage",
                spec.name,
            )
            if attempts > 0:
                # repeated losses of the same lineage back off exponentially
                # (a flapping node must not see a reconstruction hot loop)
                await asyncio.sleep(self._backoff(attempts))
            refs = spec.return_refs()
            for r in refs:
                self.memory_store.delete(r.id)
                self.locations.pop(r.id, None)
            await self._submit_and_track(spec, refs)
            return True
        finally:
            ev.set()
            self._reconstructing.pop(key, None)

    def handle_object_lost(self, conn, oid_hex, task_id_bin=None):
        """A borrower failed to read one of our objects: reconstruct."""
        oid = ObjectID.from_hex(oid_hex)
        tid = self._return_oid_task.get(oid.binary())
        if tid is None:
            return False
        ref = ObjectRef(oid, owner_addr=self.address, task_id=tid)
        self.io.spawn(self._reconstruct(ref))
        return True

    # ---------------------------------------------------------- actor calls
    def create_actor(self, cls, args, kwargs, options: RemoteOptions) -> ActorID:
        _refuse_unported(options)
        actor_id = ActorID.from_random()
        pg_id, pg_index = _pg_fields(options)
        blob = _pickle_callable(cls)
        fn_id = ts.function_id(blob)
        if fn_id not in self._registered_fns:
            self.io.run(
                self._gcs_call_retrying(
                    "register_function", fn_id=fn_id, blob=blob
                )
            )
            self._registered_fns.add(fn_id)
            self._registered_blobs[fn_id] = blob
        enc_args, enc_kwargs = ts.encode_args(args, kwargs, self.put)
        spec = ts.TaskSpec(
            task_id=TaskID.from_random(),
            name=f"{cls.__name__}.__init__",
            fn_id=fn_id,
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=0,
            resources=options.task_resources(is_actor=True),
            owner_addr=self.address,
            actor_id=actor_id,
            is_actor_creation=True,
            actor_options={"max_concurrency": options.max_concurrency},
        )
        # an argument past the inline limit went to the store as a ref that
        # nothing else holds: without a pin it is freed before the actor's
        # worker fetches it, and the constructor fails (the actor is dead)
        self._pin_task_args(spec.task_id, enc_args, enc_kwargs)
        self._actor_creation_tasks[actor_id.binary()] = spec.task_id
        reply = self.io.run(
            self._gcs_call_retrying(
                "create_actor",
                actor_id=actor_id.binary(),
                spec_blob=cloudpickle.dumps(spec),
                name=options.name,
                namespace=options.namespace or "default",
                detached=options.lifetime == "detached",
                max_restarts=options.max_restarts,
                resources=spec.resources,
                get_if_exists=options.get_if_exists,
                pg_id=pg_id,
                bundle_index=-1 if pg_index is None else pg_index,
            )
        )
        return ActorID(reply["actor_id"])

    def submit_actor_task(self, actor_id: ActorID, method, args, kwargs,
                          options: RemoteOptions):
        _refuse_unported(options)
        task_id = TaskID.from_random()
        enc_args, enc_kwargs = ts.encode_args(args, kwargs, self.put)
        streaming = options.num_returns == "streaming"
        spec = ts.TaskSpec(
            task_id=task_id,
            name=method,
            fn_id=b"",
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=0 if streaming else max(1, options.num_returns),
            resources={},
            owner_addr=self.address,
            actor_id=actor_id,
            actor_method=method,
            max_retries=options.max_task_retries,
            streaming=streaming,
            backpressure=options.generator_backpressure_num_objects,
            trace_id=tracing.current_trace_id(),
            parent_task_id=tracing.current_task_id(),
            job_id=self.job_id or tracing.current_job_id(),
            deadline=tracing.current_deadline(),
        )
        self._stamp_deadline_clocks(spec)
        self._record_task_event(spec, "SUBMITTED")
        out = None
        if streaming:
            from ray_tpu_torch.streaming import ObjectRefGenerator

            state = self._make_stream(task_id, spec.backpressure, method)
            refs: List[ObjectRef] = []
            out = ObjectRefGenerator(state)
        else:
            refs = spec.return_refs()
            for r in refs:
                self._own(r.id)  # owned, but not lineage-rebuildable
        self._pin_task_args(task_id, enc_args, enc_kwargs)
        # Pipelined per-actor submission (parity:
        # direct_actor_task_submitter.h seq-no pipelining): up to
        # actor_max_inflight_calls ride the wire concurrently. Ordering on
        # the happy path is free — one TCP connection delivers frames in
        # send order and the receiver's single-thread executor runs them
        # FIFO (worker_main.handle_push_actor_task). On a connection loss
        # the window closes, in-flight sends settle, and failed calls are
        # re-driven one-by-one in sequence order against the restarted
        # actor before the window reopens (restart-safe ordering).
        with self._lock:
            st = self._actor_queues.get(actor_id.binary())
            if st is None:
                st = _ActorSubmitState(_config.actor_max_inflight_calls)
                self._actor_queues[actor_id.binary()] = st
                self.io.spawn(
                    self._actor_queue_consumer(actor_id.binary(), st)
                )
        # batched wake, same FIFO: queue order (not wake count) carries the
        # actor's seq ordering, so a 100-call burst costs one self-pipe write
        self.io.call_batched(st.queue.put_nowait, (spec, refs))
        return out if out is not None else refs

    async def _actor_queue_consumer(self, actor_bin: bytes, st: "_ActorSubmitState"):
        """Single sender per actor: address resolution AND the frame write
        happen here, strictly in seq order — only response awaits run
        concurrently. Concurrent per-call resolution raced (GCS wait_alive
        responses complete in arbitrary order), letting seq N+1's frame hit
        the wire first."""
        while True:
            spec, refs = await st.queue.get()
            seq = st.next_seq
            st.next_seq += 1
            await st.gate.wait()        # closed while a recovery is replaying
            if self._shed_expired(spec):
                # queued past its deadline (window full behind a slow actor):
                # shed typed without burning a wire round trip
                if spec.streaming:
                    self._fail_stream(spec, self._deadline_error(spec))
                else:
                    self._store_task_error(
                        refs, self._deadline_error(spec), spec=spec
                    )
                continue
            await st.sem.acquire()
            st.inflight[seq] = (spec, refs)
            try:
                addr = await self._resolve_actor(actor_bin)
                if addr is None:
                    self._store_task_error(
                        refs,
                        exc.ActorDiedError(spec.actor_id, "actor is dead"),
                        spec=spec,
                    )
                    st.inflight.pop(seq, None)
                    st.sem.release()
                    continue
                conn = await self._conn_to(addr, kind="worker")
                if conn is None or not st.gate.is_set():
                    # Never sent: either the cached address is stale (actor
                    # restarting — _conn_to can't reach it) or a loss fired
                    # while we resolved. Hand to the ordered recovery replay,
                    # which re-resolves on its own budget — this must NOT
                    # burn max_task_retries / fail at-most-once calls, since
                    # the call was never delivered.
                    st.inflight.pop(seq, None)
                    st.sem.release()
                    st.failed[seq] = (spec, refs)
                    self._actor_addr_cache.pop(actor_bin, None)
                    if not st.recovering:
                        st.recovering = True
                        st.gate.clear()
                        self._hold_bg(
                            asyncio.ensure_future(
                                self._recover_actor_calls(st)))
                    continue
                fut = await conn.call_start_batched(
                    "push_actor_task", spec=spec
                )
            except rpc.ConnectionLost:
                st.inflight.pop(seq, None)
                st.sem.release()
                self._on_pipelined_loss(actor_bin, st, seq, spec, refs)
                continue
            except Exception as e:  # noqa: BLE001 - must not lose the refs
                self._store_task_error(
                    refs, exc.RayTpuError(f"actor submission failed: {e!r}"),
                    spec=spec,
                )
                st.inflight.pop(seq, None)
                st.sem.release()
                continue
            task = asyncio.create_task(
                self._pipelined_await(actor_bin, st, seq, spec, refs, fut)
            )
            st.tasks.add(task)
            task.add_done_callback(st.tasks.discard)

    async def _pipelined_await(self, actor_bin, st, seq, spec, refs, fut):
        try:
            result = await fut
            self._store_task_result(spec, refs, result)
        except rpc.ConnectionLost:
            self._on_pipelined_loss(actor_bin, st, seq, spec, refs)
        except Exception as e:  # noqa: BLE001 - must not lose the refs
            self._store_task_error(
                refs, exc.RayTpuError(f"actor submission failed: {e!r}"),
                spec=spec,
            )
        finally:
            st.inflight.pop(seq, None)
            st.sem.release()

    def _on_pipelined_loss(self, actor_bin, st, seq, spec, refs):
        """Connection loss on a pipelined call: close the window NOW (before
        any further send can resolve the restarted actor's address) and queue
        the call for ordered replay. At-most-once calls (max_retries<=0) may
        have executed before the connection died, so they fail instead.
        Streaming calls replay only while provably unstarted (no item pushed
        AND max_task_retries allows it — same rule as the sequential path);
        otherwise items may already have been consumed, so the producer's
        death surfaces as ActorDiedError on the consumer's next item (items
        already pushed stay consumable)."""
        self._actor_addr_cache.pop(actor_bin, None)
        if spec.streaming:
            state = self._streams.get(spec.task_id.binary())
            if state is None or state.count > 0 or spec.max_retries <= 0:
                self._fail_stream(
                    spec,
                    exc.ActorDiedError(
                        spec.actor_id, "actor worker died mid-stream"
                    ),
                )
            else:
                st.failed[seq] = (spec, refs)
        elif spec.max_retries <= 0:
            self._store_task_error(
                refs,
                exc.ActorDiedError(
                    spec.actor_id, "actor worker died during call"
                ),
                spec=spec,
            )
        else:
            st.failed[seq] = (spec, refs)
        if not st.recovering:
            st.recovering = True
            st.gate.clear()
            self._hold_bg(
                asyncio.ensure_future(self._recover_actor_calls(st)))

    async def _recover_actor_calls(self, st: "_ActorSubmitState"):
        """Replay failed calls in sequence order after a connection loss.
        Loops until no in-flight call remains AND no failed entry remains:
        in-flight calls that fail mid-recovery join st.failed and are picked
        up by the next pass instead of being stranded forever."""
        try:
            while True:
                while st.inflight:       # let concurrent sends settle
                    await asyncio.sleep(0.01)
                if not st.failed:
                    break
                while st.failed:
                    seq = min(st.failed)
                    spec, refs = st.failed.pop(seq)
                    try:
                        await self._submit_actor_task_async(spec, refs)
                    except Exception as e:  # noqa: BLE001
                        self._store_task_error(
                            refs,
                            exc.RayTpuError(f"actor submission failed: {e!r}"),
                            spec=spec,
                        )
        finally:
            st.recovering = False
            st.gate.set()

    async def _submit_actor_task_async(self, spec: ts.TaskSpec, refs):
        # sequential (await-each-response) path, used for recovery replay
        # in-flight failures burn max_task_retries (reference semantics);
        # stale-address resolution failures retry on their own budget —
        # a restarting actor must not fail calls that were never delivered
        call_retries = max(0, spec.max_retries)
        call_attempt = 0
        resolve_attempt = 0
        while True:
            if self._shed_expired(spec):
                self._store_task_error(
                    refs, self._deadline_error(spec), spec=spec
                )
                return
            addr = await self._resolve_actor(spec.actor_id.binary())
            if addr is None:
                self._store_task_error(
                    refs, exc.ActorDiedError(spec.actor_id, "actor is dead"),
                    spec=spec,
                )
                return
            conn = await self._conn_to(addr, kind="worker")
            if conn is None:
                self._actor_addr_cache.pop(spec.actor_id.binary(), None)
                resolve_attempt += 1
                if resolve_attempt > 10:
                    self._store_task_error(
                        refs, exc.ActorDiedError(spec.actor_id, "unreachable"),
                        spec=spec,
                    )
                    return
                await asyncio.sleep(
                    self._backoff(resolve_attempt, actor=True)
                )
                continue
            try:
                result = await conn.call_batched(
                    "push_actor_task", spec=spec, timeout=None,
                )
                self._store_task_result(spec, refs, result)
                return
            except rpc.ConnectionLost:
                self._actor_addr_cache.pop(spec.actor_id.binary(), None)
                if spec.streaming:
                    state = self._streams.get(spec.task_id.binary())
                    if state is not None and state.count > 0:
                        # items may already be consumed: a replay would
                        # duplicate them — fail on the next item instead
                        self._fail_stream(
                            spec,
                            exc.ActorDiedError(
                                spec.actor_id, "actor worker died mid-stream"
                            ),
                        )
                        return
                call_attempt += 1
                if call_attempt > call_retries:
                    self._store_task_error(
                        refs,
                        exc.ActorDiedError(
                            spec.actor_id, "actor worker died during call"
                        ),
                        spec=spec,
                    )
                    return
                await asyncio.sleep(
                    self._backoff(call_attempt, actor=True)
                )

    async def _resolve_actor(self, actor_id: bytes) -> Optional[str]:
        addr = self._actor_addr_cache.get(actor_id)
        if addr:
            return addr
        info = await self.gcs.call(
            "get_actor", actor_id=actor_id, wait_alive=True,
            wait_timeout=60, timeout=90,
        )
        if info is None or info["state"] != "ALIVE":
            return None
        self._actor_addr_cache[actor_id] = info["address"]
        return info["address"]

    def kill_actor(self, actor_id: ActorID, no_restart: bool,
                   wait: bool = True):
        """wait=False fires the kill without blocking on the reply — the
        ONLY safe mode from GC/__del__ paths: a handle collected while the
        io-loop thread itself is allocating (ActorHandle.__del__ →
        free_actor) would otherwise io.run() against its own loop and
        deadlock the whole process (caught by test_cluster_runtime hanging
        under suite-level GC pressure)."""
        coro = self.gcs.call(
            "kill_actor", actor_id=actor_id.binary(), no_restart=no_restart
        )
        if wait:
            self.io.run(coro)
        else:
            async def fire(c=coro):
                try:
                    await c
                except (rpc.RpcError, rpc.ConnectionLost):
                    pass

            self.io.spawn(fire())
        self._actor_addr_cache.pop(actor_id.binary(), None)
        if no_restart:
            creation = self._actor_creation_tasks.pop(actor_id.binary(), None)
            if creation is not None:
                self.io.call_batched(self._unpin_task_args, creation)

    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        info = self.io.run(
            self.gcs.call(
                "get_named_actor", name=name, namespace=namespace or "default"
            )
        )
        if info is None:
            raise ValueError(f"Failed to look up actor '{name}'")
        return ActorID(info["actor_id"])


def _pickle_callable(fn) -> bytes:
    """cloudpickle, forcing by-VALUE serialization for callables defined in
    modules workers cannot import (user scripts, test files) — installed
    packages still pickle by reference (reference behavior: function export
    via the GCS function table, function_manager.py)."""
    import sys
    import sysconfig

    mod_name = getattr(fn, "__module__", "") or ""
    mod = sys.modules.get(mod_name)
    if mod is None or mod_name in ("__main__", "builtins"):
        return cloudpickle.dumps(fn)
    f = getattr(mod, "__file__", "") or ""
    stdlib = sysconfig.get_paths().get("stdlib", "//")
    if (
        not f
        or "site-packages" in f
        or "dist-packages" in f
        or f.startswith(stdlib)
        or "/ray_tpu_torch/" in f.replace("\\", "/")
    ):
        return cloudpickle.dumps(fn)
    try:
        cloudpickle.register_pickle_by_value(mod)
        try:
            return cloudpickle.dumps(fn)
        finally:
            cloudpickle.unregister_pickle_by_value(mod)
    except Exception:  # noqa: BLE001 - fall back to by-reference
        return cloudpickle.dumps(fn)


class _ActorSubmitState:
    """Per-actor pipelined submission window (client side of the seq-no
    protocol; see submit_actor_task)."""

    def __init__(self, window: int):
        self.queue: asyncio.Queue = asyncio.Queue()
        self.sem = asyncio.Semaphore(max(1, window))
        self.next_seq = 0
        self.inflight: Dict[int, tuple] = {}
        self.failed: Dict[int, tuple] = {}
        self.recovering = False
        self.gate = asyncio.Event()
        self.gate.set()
        self.tasks: set = set()


def _refuse_unported(options: RemoteOptions) -> None:
    """Options whose planes are not ported: refused, never ignored."""
    if options.runtime_env:
        raise NotImplementedError(
            "runtime_env needs the runtime-env plane (packages staged through "
            "the GCS KV into each worker), which is not ported yet (ROADMAP "
            "Queue A item 5)"
        )


def _pg_fields(options: RemoteOptions):
    pg = options.placement_group
    if pg is None:
        return None, -1
    from ray_tpu_torch.util.placement_group import PlacementGroup

    if isinstance(pg, PlacementGroup):
        return pg.id.binary(), options.placement_group_bundle_index
    return pg, options.placement_group_bundle_index

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
leases (one task at a time on a leased worker), ownership, distributed
reference counting, borrows, lineage reconstruction, pin renewal and the
per-actor ordered submission window. Not ported yet: the reference's
pipelined submission (several tasks in flight on one leased worker) with
its work stealing and requeue bound. Cut with their planes: task events
and trace/job/deadline propagation (tracing), metrics, ``runtime_env``
and ``num_returns="streaming"`` (both refused with NotImplementedError), and the cross-node
object paths (raylet pulls, the survivor-holder probe, arg-locality hints,
spillback), which come with the multi-node slice 2b.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import cloudpickle

from ray_tpu_torch import exceptions as exc
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


@dataclass(eq=False)  # identity semantics: list.remove can never conflate
class _LeaseEntry:    # two same-shaped leases
    """One cached worker lease (scheduling-key lease reuse).

    A lease runs one task at a time: ``inflight`` is 1 between acquire and
    release; ``pooled`` mirrors membership in pool.idle (single source of
    truth for the list); ``dropped`` makes concurrent failure paths return
    the lease only once. ``gpu_ids`` are the cards the raylet gave the
    lease, which the worker makes its CUDA_VISIBLE_DEVICES.
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
    gpu_ids: Optional[List[str]] = None


class _LeasePool:
    """Per-scheduling-key lease state: idle entries + outstanding count."""

    def __init__(self):
        self.idle: List[_LeaseEntry] = []
        self.pending = 0  # unresolved lease REQUESTS only (rate-limit gate)
        self.backlog = 0  # submitters currently inside _acquire_lease
        self.batch_inflight = False  # one opportunistic batch request at a time
        self.error: Optional[BaseException] = None  # latest failed request
        from collections import deque

        self._waiters: "deque" = deque()

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
        # driver: GCS-assigned job id
        self.job_id: Optional[str] = None
        self._lock = threading.Lock()
        # actor lifecycle listeners fed by the GCS "actor" pubsub channel
        # (compiled graphs subscribe their participants here)
        self._actor_listeners: List[Any] = []

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

    # ------------------------------------------------------------- put/get
    def _put_one(self, value: Any) -> ObjectRef:
        """Shared body of put/put_batch: allocate, serialize, own, store."""
        oid = ObjectID.for_put(self.worker_id)
        data = serialization.serialize(value).to_bytes()
        ref = ObjectRef(oid, owner_addr=self.address)
        self._own(oid)
        if len(data) <= _config.max_direct_call_object_size:
            self.memory_store.put_value(oid, data)
        else:
            self._put_shm(oid, data)
        return ref

    def put(self, value: Any) -> ObjectRef:
        return self._put_one(value)

    def put_batch(self, values: Sequence[Any]) -> List[ObjectRef]:
        """Batched ray.put: one pass, shm location records coalesced into a
        single object_added_batch flush (the dispatch-plane metadata
        batching). Per-value work is already loop-wake-free for small
        objects (see _MemoryStore._wake)."""
        return [self._put_one(value) for value in values]

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

    async def _read_location(self, oid: ObjectID, loc: Optional[dict]):
        if loc is None:
            return exc.ObjectLostError(oid, "no location")
        if loc["session"] == self.session:
            buf = self.shm.get(oid)
            if buf is not None:
                return buf.buffer
        # not in shm: ask the holding raylet, which restores a spilled copy
        # (on one node that raylet is ours; pulling from another node's
        # raylet comes with the multi-node slice). A failure falls through
        # to ObjectLostError → lineage reconstruction.
        conn = await self._conn_to(loc["raylet_addr"], kind="raylet")
        if conn is not None:
            try:
                data = await conn.call(
                    "fetch_object", oid_hex=oid.hex(),
                    timeout=_config.gcs_rpc_timeout_s
                    + (loc.get("nbytes") or 0) / (1 << 30) * 60,
                )
                if data is not None:
                    return rpc.unwrap_oob(data)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        return exc.ObjectLostError(oid, "object unavailable")

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
        spec = ts.TaskSpec(
            task_id=task_id,
            name=getattr(func, "__name__", "task"),
            fn_id=fn_id,
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=max(1, options.num_returns),
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
        )
        self.submitted_specs[task_id] = spec
        self._pin_task_args(task_id, enc_args, enc_kwargs)
        refs = spec.return_refs()
        for r in refs:
            self._own(r.id, task_id)
        # batched wake: a 50-in-flight submission burst from the driver
        # thread costs one self-pipe write, not 50
        self.io.call_batched(self._submit_and_track(spec, refs))
        return refs

    async def _submit_and_track(self, spec: ts.TaskSpec, refs: List[ObjectRef]):
        attempts = 0
        while True:
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

    def _sched_key(self, spec: ts.TaskSpec):
        return (
            tuple(sorted(spec.resources.items())),
            spec.placement_group_id,
            spec.placement_group_bundle_index,
            repr(spec.scheduling_strategy),
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
            return result

    def _release_lease_slot(self, pool: "_LeasePool", entry: "_LeaseEntry"):
        """The lease's task settled: re-pool the entry."""
        entry.inflight -= 1
        entry.last_used = time.monotonic()
        if entry.conn is not None and entry.conn.closed:
            entry.dropped = True  # conn died: never hand this entry out again
        self._pool_entry(pool, entry)

    def _pool_entry(self, pool: "_LeasePool", entry: "_LeaseEntry") -> None:
        if not entry.dropped and not entry.pooled:
            entry.pooled = True
            pool.idle.append(entry)
        pool.wake()

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
        while True:
            while pool.idle:
                entry = pool.idle.pop()
                entry.pooled = False
                if entry.conn is None or entry.conn.closed:
                    await self._drop_lease(pool, entry)
                    continue
                entry.inflight += 1
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


    async def _prefetch_leases(self, pool: "_LeasePool", spec, count: int):
        """Opportunistic batched lease request (raylet request_lease_batch):
        one RPC asks for `count` leases on behalf of the scheduling key's
        backlog. Grants land in the shared idle pool and serve whichever
        submitter pops first; non-grant replies just free the budget (the
        authoritative single requests still drive infeasibility).
        """
        try:
            raylet = await self._ensure_raylet()
            if raylet is None or raylet.closed:
                return
            raylet_addr = self.raylet_address
            try:
                replies = await raylet.call(
                    "request_lease_batch",
                    resources=spec.resources,
                    count=count,
                    pg_id=spec.placement_group_id,
                    bundle_index=spec.placement_group_bundle_index,
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
        if entry.dropped:  # concurrent failure paths may both see the death
            pool.wake()
            return
        entry.dropped = True
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
        if holder is not None:
            holder["raylet"] = raylet
        try:
            reply = await raylet.call(
                "request_lease",
                resources=spec.resources,
                pg_id=spec.placement_group_id,
                bundle_index=spec.placement_group_bundle_index,
                req_id=req_id,
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
        raise exc.RayTpuError(
            f"task {spec.name} infeasible: {reply.get('reason')}"
        )

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
        kind: inline|location|error."""
        entries = result["results"]
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
        # last local copy dies after that), see _maybe_free.
        granted = result.get("granted") or []
        if granted:
            pins = [r.id.binary() for r in refs]
            for oid_hex, owner_addr in granted:
                key = ObjectID.from_hex(oid_hex).binary()
                if self._is_owner(owner_addr):
                    continue
                self._reported_borrows.add(key)
                self._granted_owner[key] = owner_addr
                self._granting_outers.setdefault(key, set()).update(pins)
                for ok in pins:
                    self._granted_by_outer.setdefault(ok, set()).add(key)
        self._unpin_task_args(spec.task_id)

    def _store_task_error(self, refs, error: BaseException, spec=None):
        for ref in refs:
            self.memory_store.put_error(ref.id, error)
        if refs:
            self._unpin_task_args(refs[0].task_id)

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
        spec = ts.TaskSpec(
            task_id=task_id,
            name=method,
            fn_id=b"",
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=max(1, options.num_returns),
            resources={},
            owner_addr=self.address,
            actor_id=actor_id,
            actor_method=method,
            max_retries=options.max_task_retries,
        )
        refs = spec.return_refs()
        for r in refs:
            self._own(r.id)  # owned, but not lineage-rebuildable
        self._pin_task_args(task_id, enc_args, enc_kwargs)
        # Pipelined per-actor submission        self._pin_task_args(task_id, enc_args, enc_kwargs)
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
        return refs

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
        have executed before the connection died, so they fail instead."""
        self._actor_addr_cache.pop(actor_bin, None)
        if spec.max_retries <= 0:
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
    if options.num_returns == "streaming":
        from ray_tpu_torch.core.local_backend import _refuse_streaming

        _refuse_streaming()
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

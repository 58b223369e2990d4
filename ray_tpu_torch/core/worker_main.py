"""Worker process: executes tasks pushed by owners.

Parity: CoreWorkerProcess::RunTaskExecutionLoop (core_worker_process.cc:63) +
the Cython execute_task callback (_raylet.pyx:1318). The worker is also a full
CoreWorker (it owns objects created by nested submissions). Actor workers keep
per-owner sequence buffers so actor tasks execute in submission order
(actor_scheduling_queue.h analog).

The port's copy of ray_tpu/core/worker_main.py, started by the raylet as
``python -m ray_tpu_torch.core.worker_main``. It imports torch (through the
package) but touches no card until a task does, so an idle worker holds no
CUDA context; its kernels load from the build directory the driver built.
The watchdog is kept: a worker exits when its raylet dies. Plain tasks run
one at a time under a stealable run slot: an owner pipelines up to
``worker_max_tasks_in_flight`` of them onto one lease, a queued one bounces
back (``{"requeue": True}``) when an owner steals it for an idle worker or
when it cannot start within ``worker_requeue_after_ms``, and a task blocked
in ``get`` hands the slot on. A streaming task or actor method
(``num_returns="streaming"``) pushes each yielded item to its owner as it
is produced, with credit-based backpressure. Every task runs in its task
context (trace, job, deadline), records its task events, and appends them
to the worker's task-event WAL; an expired deadline is shed before user
code runs. Cut with their planes: ``runtime_env``, chaos and the compiled
graphs' generic call entry point.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import logging
import os
import threading
import time
import traceback
from typing import Dict, Optional

import cloudpickle

# A worker imports torch as it starts, before it registers, so that an idle
# worker has it ready for its first task that needs it (6-10 s of import on
# the card's host); importing it later, on another thread than a task's
# unpickling, races that unpickling's own import of torch. It opens no CUDA
# context: a task that touches the card does. The GCS and the raylet never
# import it.
import torch  # noqa: F401

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch import tracing
from ray_tpu_torch.core import rpc, serialization, task_spec as ts
from ray_tpu_torch.core.config import _config
from ray_tpu_torch.core.core_worker import CoreWorker
from ray_tpu_torch.core.ids import ObjectID

logger = logging.getLogger(__name__)


class _StealableRunSlot:
    """The plain-task execution slot, with work stealing.

    One task RUNS at a time (the slot); tasks pushed behind it WAIT here.
    An owner that sees another of its leased workers go idle sends
    ``steal_tasks`` — waiting (queued, never-started) tasks are marked
    stolen and bounce back ``{"requeue": True}`` immediately, so a spec
    committed to a busy worker migrates to the idle one instead of waiting
    out ``worker_requeue_after_ms`` behind a long/out-of-band-blocking
    task. A task that already holds the slot can never be stolen."""

    def __init__(self):
        self._cv = threading.Condition()
        self._held = False
        # task_id hex -> stolen flag, insertion-ordered (steal takes the
        # NEWEST waiters: they are the furthest from running)
        self._waiters: Dict[str, bool] = {}
        self.steals = 0  # lifetime stolen-task count (stats/tests)

    def acquire_for(self, task_id: str, timeout: float) -> str:
        """Wait for the slot as task ``task_id``; returns "acquired",
        "stolen" (an owner reclaimed this spec) or "timeout"."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            self._waiters[task_id] = False
            try:
                while True:
                    if self._waiters[task_id]:
                        return "stolen"
                    if not self._held:
                        self._held = True
                        return "acquired"
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return "timeout"
                    self._cv.wait(remaining)
            finally:
                self._waiters.pop(task_id, None)

    def acquire(self) -> None:
        """Unconditional re-take (the yield-slot path resuming a blocked
        task); never steals, never times out."""
        with self._cv:
            while self._held:
                self._cv.wait()
            self._held = True

    def release(self) -> None:
        with self._cv:
            self._held = False
            self._cv.notify_all()

    def steal(self, n: int) -> int:
        """Mark up to ``n`` waiting tasks stolen (newest first); they bounce
        back to their owner for resubmission elsewhere."""
        with self._cv:
            pending = [t for t, stolen in self._waiters.items() if not stolen]
            take = pending[-max(0, n):] if n > 0 else []
            for tid in take:
                self._waiters[tid] = True
            if take:
                self.steals += len(take)
                self._cv.notify_all()
            return len(take)


class WorkerAgent(CoreWorker):
    def __init__(self, gcs_address, raylet_address, session, node_id):
        super().__init__(gcs_address, raylet_address, session, node_id, mode="worker")
        # workers are children of their raylet: a changed parent means the
        # raylet is dead
        self._raylet_pid = os.getppid()
        # Plain-task execution: one RUNNING task at a time (the slot), but a
        # wide thread pool so a task blocked in get() can hand its slot to
        # the next pipelined task instead of starving it (the in-process
        # mirror of the raylet's blocked-worker resource release — without
        # it, pipelined submission deadlocks on tasks-that-get-tasks).
        # Actor workers swap in a dedicated serial pool at init: actor-call
        # ordering relies on the executor serializing, never on this slot.
        self._exec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="task-exec"
        )
        self._exec_slot = _StealableRunSlot()
        self._slot_state = threading.local()
        # actor state
        self.actor_instance = None
        self.actor_id: Optional[bytes] = None
        self._actor_ready = threading.Event()
        self._actor_init_error: Optional[BaseException] = None

    def orphaned(self) -> bool:
        return os.getppid() != self._raylet_pid or (
            self.raylet is not None and self.raylet.closed)

    # -------------------------------------------------------- registration
    def register_with_raylet(self, startup_token: int):
        reply = self.io.run(
            self.raylet.call(
                "register_worker",
                startup_token=startup_token,
                worker_id=self.worker_id.hex(),
                address=self.address,
            )
        )
        if reply is None:
            raise RuntimeError("raylet rejected registration")
        if reply.get("actor_id") is not None:
            self.actor_id = reply["actor_id"]
            spec_blob = reply.get("actor_spec")
            threading.Thread(
                target=self._init_actor, args=(spec_blob,), daemon=True
            ).start()
        return reply

    # --------------------------------------------------------------- tasks
    async def handle_push_task(self, conn, spec=None, spec_blob=None,
                               gpu_ids=None):
        # specs arrive as objects in the frame payload (possibly many per
        # BATCH frame); spec_blob kept for pre-batching callers
        if self.orphaned():
            # the watchdog below polls once a second; an owner's cached lease
            # on this worker must not run a task in the meantime, whose
            # result would name a dead raylet as its holder. Exiting makes
            # the owner see the worker crash and retry on a live node.
            logger.info("push_task after the raylet died; exiting")
            os._exit(0)
        spec: ts.TaskSpec = spec if spec is not None else cloudpickle.loads(
            spec_blob)
        logger.debug("push_task %s %s", spec.name, spec.task_id.hex()[:8])
        if gpu_ids is not None:
            # the lease's cards; the raylet leases this worker no other
            # cards afterwards, since a CUDA context stays where it opened
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(gpu_ids)
        loop = asyncio.get_running_loop()
        if spec.streaming:
            return await loop.run_in_executor(
                self._exec_pool, self._run_slotted, spec,
                self._execute_streaming, spec, conn,
            )
        return await loop.run_in_executor(
            self._exec_pool, self._run_slotted, spec, self._execute, spec
        )

    async def handle_steal_tasks(self, conn, n=1):
        """An owner with an idle leased worker reclaims queued-but-not-
        started specs from this (busy) one; each stolen spec's push_task
        reply bounces ``{"requeue": True}`` and the owner resubmits it to
        the idle worker."""
        return {"stolen": self._exec_slot.steal(int(n))}

    def _run_slotted(self, spec, fn, *args):
        """Run one pushed task under the single execution slot. The slot —
        not the pool width — is what keeps plain-task execution serial;
        get_blocking hands it over for the duration of a blocking get.
        A queued task bounces back to the owner ({"requeue": True}) either
        when an owner STEALS it for an idle worker (immediate) or after
        worker_requeue_after_ms (fallback bound when no worker is idle) —
        a long/blocking peer must not pin queued tasks."""
        outcome = self._exec_slot.acquire_for(
            spec.task_id.hex(),
            max(0.0, _config.worker_requeue_after_ms) / 1000.0,
        )
        if outcome != "acquired":
            return {"requeue": True, "why": outcome}
        self._slot_state.held = True
        try:
            return fn(*args)
        finally:
            if getattr(self._slot_state, "held", False):
                self._slot_state.held = False
                self._exec_slot.release()

    @contextlib.contextmanager
    def _yield_exec_slot(self):
        """While the current task blocks (get, stream wait), release the
        execution slot so the next pipelined task runs; re-acquire before
        resuming. No-op off the slotted plain-task path."""
        yielded = getattr(self._slot_state, "held", False)
        if yielded:
            self._slot_state.held = False
            self._exec_slot.release()
        try:
            yield
        finally:
            if yielded:
                self._exec_slot.acquire()
                self._slot_state.held = True

    # ------------------------------------------------- blocked-worker plane
    # Parity: the reference's NotifyDirectCallTaskBlocked/Unblocked — a task
    # blocking in ray.get must release its lease's CPU so the tasks it waits
    # on can be scheduled; without this, tasks-that-get-tasks deadlock once
    # blocked tasks occupy every worker (hit by the shuffle pipeline: reduce
    # tasks held all workers while their upstream map tasks starved).
    def _notify_blocked(self, blocked: bool) -> None:
        if self.raylet is None or self.raylet.closed:
            return
        method = "worker_blocked" if blocked else "worker_unblocked"
        try:
            self.io.spawn(self.raylet.notify(method, worker_id=self.worker_id.hex()))
        except Exception:  # noqa: BLE001 - advisory only
            pass

    @contextlib.contextmanager
    def blocked(self):
        """While the current task waits on other work (a get, or the next
        item of a stream it consumes): tell the raylet this worker is
        blocked, and hand the execution slot on."""
        self._notify_blocked(True)
        try:
            with self._yield_exec_slot():
                yield
        finally:
            self._notify_blocked(False)

    def get_blocking(self, refs, timeout):
        """get() that tells the raylet this worker is blocked meanwhile,
        and hands the execution slot on."""
        with self.blocked():
            return self.get(refs, timeout)

    def _task_ctx(self, spec: ts.TaskSpec):
        """Tracing context for the executing task: nested submissions made
        by the user function inherit this task as parent, ride the
        request's trace id, carry the job, and inherit the request deadline
        (all propagated through the spec). User code reads the remaining
        budget via ``ray_tpu_torch.remaining_time_s()``."""
        return tracing.task_context(
            spec.task_id.hex(), getattr(spec, "trace_id", None),
            getattr(spec, "job_id", None),
            deadline=getattr(spec, "deadline", None),
        )

    def _shed_if_expired(self, spec: ts.TaskSpec):
        """Pre-execution admission (overload protection): a spec whose
        request deadline already passed is failed typed WITHOUT running
        user code — the client stopped waiting, so executing it would only
        steal worker time from requests that can still make their SLO.
        Returns the error reply to send, or None to proceed."""
        # first touch in this process: re-anchor the owner-minted deadline
        # into the local clock domain (NTP-skew guard — a skewed receiver
        # clamps instead of falsely shedding; see ts.effective_deadline)
        deadline = ts.localize_deadline(spec)
        if deadline is None or time.time() < deadline:
            return None
        from ray_tpu_torch.util.metrics import deadline_expired_counter

        c = deadline_expired_counter()
        if c is not None:
            c.inc(1.0, {"where": "worker"})
        self._record_task_event(spec, "FAILED")
        err = exc.DeadlineExceededError(
            f"task {spec.name} shed before execution: request deadline "
            f"exceeded by {time.time() - deadline:.3f}s"
        )
        return self._error_result(spec, err, system=True)

    def _execute(self, spec: ts.TaskSpec) -> dict:
        shed = self._shed_if_expired(spec)
        if shed is not None:
            return shed
        self._record_task_event(spec, "RUNNING")
        try:
            with self._task_ctx(spec):
                # cache hit stays on this thread: io.run costs two cross-
                # thread hops, which dominate a short task's wall time
                fn = self._fn_cache.get(spec.fn_id)
                if fn is None:
                    fn = self.io.run(self.load_function(spec.fn_id))
                args, kwargs = ts.decode_args(
                    spec.args, spec.kwargs,
                    lambda refs: self.get_blocking(refs, None),
                )
                attempts = 0
                while True:
                    try:
                        result = fn(*args, **kwargs)
                        break
                    except Exception as e:  # noqa: BLE001 - user exception
                        attempts += 1
                        if spec.retry_exceptions and attempts <= spec.max_retries:
                            time.sleep(self._backoff(attempts))
                            continue
                        return self._attach_borrows(spec, self._error_result(spec, e))
            self._record_task_event(spec, "EXECUTED")
            return self._attach_borrows(spec, self._success_result(spec, result))
        except exc.RayTpuError as e:
            return self._attach_borrows(spec, self._error_result(spec, e, system=True))
        except BaseException as e:  # noqa: BLE001
            return self._attach_borrows(spec, self._error_result(spec, e))

    def _attach_borrows(self, spec: ts.TaskSpec, result: dict) -> dict:
        """Refs deserialized here that survive the task are borrows; announce
        them in the reply (submitter-owned, so registration beats the arg
        unpin) or straight to their owner (cross-owner refs)."""
        try:
            borrows = []
            for oid_hex, owner in self.report_new_borrows():
                if owner == spec.owner_addr:
                    borrows.append((oid_hex, self.address))
                else:
                    # third-party owner: ACK before replying — once we reply,
                    # the submitter may release ITS borrow, and an async add
                    # racing that release lets the owner free the object
                    # while we still hold a ref (same rule as
                    # _grant_result_borrows)
                    try:
                        self.io.run(
                            self._notify_owner(
                                owner, "add_borrow", oid_hex=oid_hex,
                                addr=self.address,
                            ),
                            timeout=30,
                        )
                    except Exception:  # noqa: BLE001 - owner may be gone
                        logger.warning("borrow report to %s failed", owner)
            if borrows:
                result["borrows"] = borrows
        except Exception:  # noqa: BLE001 - never fail a task on bookkeeping
            logger.exception("borrow reporting failed")
        return result

    def _success_result(self, spec: ts.TaskSpec, result) -> dict:
        n = spec.num_returns
        values = [result] if n == 1 else list(result)
        if n != 1 and len(values) != n:
            return self._error_result(
                spec,
                ValueError(
                    f"task declared num_returns={n} but returned {len(values)}"
                ),
            )
        entries = []
        granted = []
        for i, v in enumerate(values):
            oid = ObjectID.for_task_return(spec.task_id, i)
            ser = serialization.serialize(v)
            data = ser.to_bytes()
            granted.extend(self._grant_result_borrows(spec, ser.contained_refs))
            if len(data) <= _config.max_direct_call_object_size:
                # large inline results ride the reply frame's out-of-band
                # segment table: written from `data`, mapped zero-copy by
                # the owner (no re-pickle of the serialized bytes)
                if len(data) >= _config.rpc_oob_threshold_bytes:
                    entries.append(("inline", rpc.Oob(data)))
                else:
                    entries.append(("inline", data))
            else:
                self.shm.put_bytes(oid, data)
                if self.raylet:
                    self._notify_object_added(oid, len(data))
                entries.append(
                    (
                        "location",
                        {
                            "session": self.session,
                            "raylet_addr": self.raylet_address,
                            "node_id": self.node_id,
                            "nbytes": len(data),
                        },
                    )
                )
        out = {"results": entries}
        if granted:
            out["granted"] = granted
        return out

    def _grant_result_borrows(self, spec: ts.TaskSpec, contained_refs):
        """ObjectRefs inside a return value outlive this task frame in the
        CALLER's hands. Register the caller as a borrower with each ref's
        owner BEFORE replying — for self-owned refs the task-frame exit
        would otherwise free them (no local refs, no pending, no borrowers)
        while the caller still holds the nested ref. The caller releases via
        the granted list in _store_task_result."""
        granted = []
        for r in contained_refs:
            owner = r.owner_addr
            if owner == spec.owner_addr:
                continue  # caller owns it already, no borrow needed
            key = r.id.binary()
            if self._is_owner(owner):
                entry = self._owned.get(key)
                if entry is None:
                    continue
                entry["borrowers"].add(spec.owner_addr)
                granted.append((r.id.hex(), self.address))
            else:
                # third-party owner: register the caller by proxy, and ACK
                # before replying — our own borrow releases at frame exit,
                # so an async add could lose the race with the free
                try:
                    self.io.run(
                        self._notify_owner(
                            owner, "add_borrow", oid_hex=r.id.hex(),
                            addr=spec.owner_addr,
                        ),
                        timeout=30,
                    )
                    granted.append((r.id.hex(), owner))
                except Exception:  # noqa: BLE001 - owner may be gone
                    logger.warning("borrow grant to %s failed", owner)
        return granted

    def _error_result(self, spec: ts.TaskSpec, e: BaseException, system=False) -> dict:
        err = e if isinstance(e, exc.RayTpuError) else exc.TaskError.from_exception(e)
        blob = cloudpickle.dumps(err)
        return {"results": [("error", blob)] * max(1, spec.num_returns)}

    # ------------------------------------------------- streaming generators
    # Producer side of ray_tpu_torch/streaming/: drive the user generator and
    # PUSH each yielded item to the owner as its own sealed object the moment
    # it is produced — small items inline in the stream_item frame, large
    # ones through the node shm store (the owner reads them via the existing
    # location plane, never a pickle-RPC of the bytes). With a backpressure
    # window the owner withholds each stream_item reply until the consumer
    # drains, so this thread blocks in `yield` exactly like the reference's
    # generator_backpressure_num_objects.

    def _execute_streaming(self, spec: ts.TaskSpec, conn) -> dict:
        shed = self._shed_if_expired(spec)
        if shed is not None:
            return shed
        self._record_task_event(spec, "RUNNING")
        try:
            with self._task_ctx(spec):
                fn = self._fn_cache.get(spec.fn_id)
                if fn is None:
                    fn = self.io.run(self.load_function(spec.fn_id))
                args, kwargs = ts.decode_args(
                    spec.args, spec.kwargs,
                    lambda refs: self.get_blocking(refs, None),
                )
                return self._stream_items(
                    spec, conn, lambda: fn(*args, **kwargs)
                )
        except exc.RayTpuError as e:
            return self._attach_borrows(spec, self._error_result(spec, e, system=True))
        except BaseException as e:  # noqa: BLE001
            return self._attach_borrows(spec, self._error_result(spec, e))

    def _execute_actor_streaming(self, spec: ts.TaskSpec, conn) -> dict:
        self._actor_ready.wait(timeout=_config.worker_startup_timeout_s)
        if self._actor_init_error is not None:
            return self._error_result(spec, self._actor_init_error)
        shed = self._shed_if_expired(spec)
        if shed is not None:
            return shed
        self._record_task_event(spec, "RUNNING")
        try:
            with self._task_ctx(spec):
                args, kwargs = ts.decode_args(
                    spec.args, spec.kwargs, lambda refs: self.get(refs, None)
                )
                method = getattr(self.actor_instance, spec.actor_method)
                return self._stream_items(
                    spec, conn, lambda: method(*args, **kwargs)
                )
        except BaseException as e:  # noqa: BLE001
            return self._attach_borrows(spec, self._error_result(spec, e))

    def _stream_items(self, spec: ts.TaskSpec, conn, produce) -> dict:
        """Drive `produce()` (must return a generator) and push every item.

        Returns the final push_*_task reply: a single ("streamed", {total,
        error}) entry — the owner turns it into a typed end-of-stream. The
        reply is written on the same connection AFTER every stream_item
        frame, so by the time the owner resolves the call future all items
        are already in its store.
        """
        import collections

        from ray_tpu_torch.streaming.generator import as_item_iterator

        async def _await(fut):
            return await fut

        def _payload(index, kind, payload, sync):
            return dict(
                task_id_hex=spec.task_id.hex(),
                index=index, kind=kind, payload=payload, sync=sync,
            )

        async def _start(index: int, kind: str, payload):
            # batched: consecutive item pushes staged in one loop tick share
            # a multi-item BATCH frame and one gather-write
            return await conn.call_start_batched(
                "stream_item", **_payload(index, kind, payload, True)
            )

        async def _notify(index: int, kind: str, payload):
            try:
                await conn.notify_batched(
                    "stream_item", **_payload(index, kind, payload, False)
                )
            except rpc.ConnectionLost:
                pass  # the next sync point surfaces the loss

        def _reply_of(outer, block: bool):
            """(reply, settled): resolve one queued sync push. `outer` is
            the spawn future of call_start (resolves once the frame is
            written); its result is the response future. Non-blocking unless
            `block` — then (None, False) while still in flight."""
            if not block and not outer.done():
                return None, False
            inner = outer.result()  # frame written (short wait at worst)
            if inner.done():
                return inner.result(), True
            if not block:
                return None, False
            with self._yield_exec_slot():  # credit-gated: may block long
                return self.io.run(_await(inner), timeout=None), True

        def _send(index: int, kind: str, payload) -> bool:
            """Push one item WITHOUT waiting for the write (the io loop owns
            frame ordering). Every `sync_stride`-th item is a request whose
            reply carries flow control + the consumer-closed signal; the
            rest are one-way notifies (no response frame per item). Blocks
            once `max_unacked` sync points are outstanding. Returns False
            when the owner closed the stream (consumer abandoned it)."""
            if index % sync_stride == sync_stride - 1:
                pending.append(self.io.spawn(_start(index, kind, payload)))
            else:
                self.io.spawn(_notify(index, kind, payload))
            while pending:
                reply, settled = _reply_of(
                    pending[0], len(pending) >= max_unacked
                )
                if not settled:
                    return True
                pending.popleft()
                if reply and reply.get("closed"):
                    return False
            return True

        # an explicit backpressure window makes EVERY push a sync point and
        # allows exactly one outstanding (the owner's withheld reply IS the
        # credit); otherwise sync every half-cap and run two sync points
        # ahead, bounding un-acked items at ~MAX_INFLIGHT_ITEMS
        if spec.backpressure:
            sync_stride, max_unacked = 1, 1
        else:
            from ray_tpu_torch.streaming import generator

            sync_stride = max(1, generator.MAX_INFLIGHT_ITEMS // 2)
            max_unacked = 2
        pending: "collections.deque" = collections.deque()
        produced = 0
        had_error = False
        granted = []
        it = None
        try:
            try:
                result = produce()
            except Exception as e:  # noqa: BLE001 - pre-yield user error
                _send(0, "error", cloudpickle.dumps(
                    exc.TaskError.from_exception(e)))
                return self._stream_reply(spec, 1, True, granted)
            it = as_item_iterator(result)
            if it is None:
                _send(0, "error", cloudpickle.dumps(
                    exc.TaskError.from_exception(TypeError(
                        f"num_returns='streaming' requires a generator, got "
                        f"{type(result).__name__}"
                    ))))
                return self._stream_reply(spec, 1, True, granted)
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    break
                except Exception as e:  # noqa: BLE001 - mid-stream user exc
                    _send(produced, "error", cloudpickle.dumps(
                        exc.TaskError.from_exception(e)))
                    produced += 1
                    had_error = True
                    break
                kind, payload = self._encode_stream_item(spec, item, produced,
                                                         granted)
                alive = _send(produced, kind, payload)
                produced += 1
                if not alive:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
                    break
            # settle remaining pushes so the reply frame is last on the wire
            while pending:
                _reply_of(pending.popleft(), block=True)
        except rpc.ConnectionLost:
            # owner is gone: nobody to report to — stop producing
            if it is not None:
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001
                        pass
        return self._stream_reply(spec, produced, had_error, granted)

    def _stream_reply(self, spec, total, had_error, granted) -> dict:
        # tracing: one worker-side end-of-production event per stream (NOT
        # per item — pushes are the hot path) carrying the item count
        self._record_task_event(
            spec, "EXECUTED",
            args={"stream_items": total, "stream_error": bool(had_error)},
        )
        out = {"results": [("streamed", {"total": total, "error": had_error})]}
        if granted:
            out["granted"] = granted
        return self._attach_borrows(spec, out)

    def _encode_stream_item(self, spec, item, index, granted):
        """Serialize one yielded item: inline when small, shm-location when
        large (the data plane the owner already knows how to read). A CUDA
        tensor serializes through the host (core/serialization.py) and the
        owner's get gives back that host copy, a CPU tensor. Grants for ObjectRefs nested
        in the item carry the ITEM index, so the owner pins each borrow to
        that item's object (not to the stream's nonexistent return refs) —
        the pin drops when the item frees."""
        ser = serialization.serialize(item)
        granted.extend(
            (oid_hex, owner, index)
            for oid_hex, owner in self._grant_result_borrows(
                spec, ser.contained_refs
            )
        )
        data = ser.to_bytes()
        if len(data) <= _config.max_direct_call_object_size:
            if len(data) >= _config.rpc_oob_threshold_bytes:
                return "inline", rpc.Oob(data)  # zero-copy off the frame
            return "inline", data
        oid = ObjectID.for_task_return(spec.task_id, index)
        self.shm.put_bytes(oid, data)
        if self.raylet:
            self._notify_object_added(oid, len(data))
        return "location", {
            "session": self.session,
            "raylet_addr": self.raylet_address,
            "node_id": self.node_id,
            "nbytes": len(data),
        }

    # -------------------------------------------------------------- actors
    def _init_actor(self, spec_blob):
        try:
            spec: ts.TaskSpec = cloudpickle.loads(spec_blob)
            cls = self.io.run(self.load_function(spec.fn_id))
            args, kwargs = ts.decode_args(
                spec.args, spec.kwargs, lambda refs: self.get(refs, None)
            )
            opts = spec.actor_options or {}
            n = max(1, opts.get("max_concurrency", 1))
            # always replace the (wide) plain-task pool: actor-call ordering
            # relies on the executor itself serializing at max_concurrency
            self._exec_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="actor-exec"
            )
            self.actor_instance = cls(*args, **kwargs)
            self._actor_ready.set()
            self.io.run(
                self.gcs.call(
                    "actor_ready",
                    actor_id=self.actor_id,
                    address=self.address,
                    node_id=self.node_id,
                )
            )
        except BaseException as e:  # noqa: BLE001
            logger.error("actor init failed: %s", traceback.format_exc())
            self._actor_init_error = e
            self._actor_ready.set()
            try:
                self.io.run(
                    self.gcs.call(
                        "actor_failed",
                        actor_id=self.actor_id,
                        reason=f"__init__ raised {e!r}",
                    )
                )
            finally:
                os._exit(1)

    async def handle_push_actor_task(self, conn, spec=None, spec_blob=None):
        """Execute an actor call. Ordering: each owner enqueues frames in
        seq order (BATCH frames dispatch their requests in list order), and
        the executor pool serializes execution, so arrival order ==
        submission order per owner."""
        spec: ts.TaskSpec = spec if spec is not None else cloudpickle.loads(
            spec_blob)
        loop = asyncio.get_running_loop()
        # wait for init HERE (not in the executor): dispatch must land on the
        # actor's dedicated serial pool, which _init_actor installs — an early
        # push run on the wide plain-task pool would dodge the ordering queue
        while not self._actor_ready.is_set():
            await asyncio.sleep(0.01)
        if spec.streaming:
            return await loop.run_in_executor(
                self._exec_pool, self._execute_actor_streaming, spec, conn
            )
        return await loop.run_in_executor(
            self._exec_pool, self._execute_actor_task, spec
        )

    def _execute_actor_task(self, spec: ts.TaskSpec) -> dict:
        self._actor_ready.wait(timeout=_config.worker_startup_timeout_s)
        if self._actor_init_error is not None:
            return self._error_result(spec, self._actor_init_error)
        shed = self._shed_if_expired(spec)
        if shed is not None:
            return shed
        self._record_task_event(spec, "RUNNING")
        try:
            with self._task_ctx(spec):
                args, kwargs = ts.decode_args(
                    spec.args, spec.kwargs, lambda refs: self.get(refs, None)
                )
                method = getattr(self.actor_instance, spec.actor_method)
                result = method(*args, **kwargs)
                import inspect

                if inspect.iscoroutine(result):
                    result = asyncio.run(result)
            self._record_task_event(spec, "EXECUTED")
            return self._attach_borrows(spec, self._success_result(spec, result))
        except BaseException as e:  # noqa: BLE001
            return self._attach_borrows(spec, self._error_result(spec, e))


def main():
    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {os.getpid()}] %(levelname)s %(message)s",
    )
    gcs = os.environ["RAY_TPU_GCS_ADDRESS"]
    raylet = os.environ["RAY_TPU_RAYLET_ADDRESS"]
    session = os.environ["RAY_TPU_SESSION"]
    node_id = os.environ["RAY_TPU_NODE_ID"]
    token = int(os.environ["RAY_TPU_STARTUP_TOKEN"])

    agent = WorkerAgent(gcs, raylet, session, node_id)
    agent.connect()

    # crash forensics: append every task event to a per-worker WAL in the
    # (tmpfs-backed) shm session dir BEFORE the periodic flush — if this
    # process is SIGKILLed, the raylet recovers the orphaned file into the
    # aggregator so the final second of spans still closes the timeline.
    if _config.task_events_wal_enabled:
        from ray_tpu_torch.core.object_store.shm_store import session_dir

        tracing.get_buffer().enable_wal(os.path.join(
            session_dir(session), "task_wal", f"wal-{node_id}-{token}.jsonl",
        ))

    # make nested @remote calls work inside tasks. Before registering:
    # registration may start an actor's constructor, and a task may arrive
    # right after it; either one calling the API before the backend is set
    # would have _auto_init start a second cluster inside this worker
    from ray_tpu_torch import api
    from ray_tpu_torch.core.cluster_backend import ClusterBackend

    api._worker.backend = ClusterBackend(core_worker=agent)
    api._worker.mode = "worker"
    agent.register_with_raylet(token)

    # Serve until killed (all work arrives over RPC), but never outlive the
    # raylet: workers are children of the raylet process, so a dead raylet
    # reparents us to init and closes our raylet connection. Without this
    # watchdog, SIGKILL'd raylets (chaos tests, real crashes) orphan workers
    # forever. Parity: worker exit on raylet disconnect
    # (core_worker.cc Exit on raylet channel failure).
    stop = threading.Event()
    while not stop.wait(1.0):
        if agent.orphaned():
            logger.info("raylet died; exiting")
            break
    os._exit(0)


if __name__ == "__main__":
    main()

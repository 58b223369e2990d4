"""In-process backend: tasks on daemon threads, objects in a dict of futures.

The port's copy of ray_tpu/core/local_backend.py, the LOCAL_MODE analog
(reference: python/ray/_private/worker.py mode handling). Semantics match the
cluster backend — eager async execution, futures, per-actor ordered execution,
retries — so tests written against it transfer. Objects are kept as they are
(no serialization): a CUDA tensor put or returned here is the same tensor,
on the same card, when it is read back.

Not ported yet (ROADMAP Queue A): the streaming plane (``num_returns=
"streaming"`` raises NotImplementedError), tracing (task events, trace ids,
request deadlines, ``timeline``; nothing is recorded), the chaos plane (no
injection points; ``_fail_actor``, its kill hook, stays as the simulated
worker death that restarts an actor), the metrics time series,
``state_call`` (util.state), and the compiled graphs' entry point
``__ray_tpu_call__`` and ``actor_node``. The reference's named sanitizer
locks are plain ``threading.Lock``s.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.core.backend import Backend
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.options import RemoteOptions
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.util import backoff


def _refuse_streaming():
    raise NotImplementedError(
        'num_returns="streaming" needs the streaming plane, which is not '
        "ported yet (ROADMAP Queue A: streaming, tracing, chaos, metrics)"
    )


class _LocalActor:
    def __init__(self, actor_id: ActorID, options: RemoteOptions):
        self.actor_id = actor_id
        self.options = options
        self.dead = False
        self.death_reason = ""
        self.state = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
        self.restarts_left = options.max_restarts or 0
        self.num_restarts = 0
        # refs of submitted-but-unfinished tasks; errored out if the actor dies
        self.pending_refs: set = set()
        # ordered execution: one dispatch thread pulling a FIFO queue mirrors the
        # sequential actor scheduling queue (max_concurrency>1 uses a pool).
        self._pool = self._new_pool()
        self.instance = None
        self._init_future = None
        # construction recipe, kept for restarts (cluster parity: the GCS
        # keeps the creation TaskSpec and replays it on a fresh worker)
        self._recipe = None

    def _new_pool(self):
        n = max(1, self.options.max_concurrency)
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=n, thread_name_prefix=f"actor-{self.actor_id.hex()[:8]}"
        )

    def start(self, cls, args, kwargs, resolve_args, on_failure):
        self._recipe = (cls, args, kwargs, resolve_args, on_failure)
        self._init_future = self._pool.submit(
            self._construct, cls, args, kwargs, resolve_args, on_failure
        )

    def _construct(self, cls, args, kwargs, resolve_args, on_failure):
        try:
            rargs, rkwargs = resolve_args(args, kwargs)
            self.instance = cls(*rargs, **rkwargs)
            self.state = "ALIVE"
        except BaseException as e:  # noqa: BLE001 - surfaced via init future
            self.dead = True
            self.state = "DEAD"
            self.death_reason = f"__init__ failed: {e!r}"
            on_failure(self)
            raise

    def restart(self, on_alive):
        """Re-create the instance on a fresh pool (simulated worker restart:
        state is lost, like a cluster actor restarting on a new process)."""
        cls, args, kwargs, resolve_args, on_failure = self._recipe
        self.state = "RESTARTING"
        self.num_restarts += 1
        self._pool = self._new_pool()
        self.instance = None

        def construct():
            self._construct(cls, args, kwargs, resolve_args, on_failure)
            on_alive()

        self._init_future = self._pool.submit(construct)

    def submit(self, fn, *args):
        return self._pool.submit(fn, *args)

    def ensure_initialized(self):
        self._init_future.result()

    def stop(self, resolve_pending=None):
        self.dead = True
        self.state = "DEAD"
        self._pool.shutdown(wait=False, cancel_futures=True)
        if resolve_pending:
            resolve_pending(list(self.pending_refs))
            self.pending_refs.clear()


class LocalBackend(Backend):
    def __init__(self):
        self.worker_id = WorkerID.from_random()
        self._objects: Dict[ObjectID, concurrent.futures.Future] = {}
        self._actors: Dict[ActorID, _LocalActor] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._lock = threading.Lock()
        self._cancelled: set = set()
        self._actor_listeners: List[Any] = []

    # ------------------------------------------------- actor lifecycle plane
    def _emit_actor_event(self, actor_id: ActorID, state: str, reason: str = ""):
        for cb in list(self._actor_listeners):
            try:
                cb(actor_id.binary(), state, reason)
            except Exception:  # noqa: BLE001 - listeners must not break us
                pass

    def add_actor_listener(self, cb):
        self._actor_listeners.append(cb)

    def remove_actor_listener(self, cb):
        try:
            self._actor_listeners.remove(cb)
        except ValueError:
            pass

    def actor_state(self, actor_id: ActorID) -> str:
        actor = self._actors.get(actor_id)
        if actor is None or actor.dead:
            return "DEAD"
        return actor.state

    def wait_actor_alive(self, actor_id: ActorID, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while True:
            state = self.actor_state(actor_id)
            if state == "ALIVE":
                return
            if state == "DEAD":
                actor = self._actors.get(actor_id)
                raise exc.ActorDiedError(
                    actor_id, getattr(actor, "death_reason", "") or "dead"
                )
            if time.monotonic() > deadline:
                raise exc.GetTimeoutError(
                    f"actor {actor_id.hex()[:16]} not ALIVE within {timeout}s"
                )
            time.sleep(0.02)

    def _fail_actor(self, actor_id: ActorID, reason: str = "worker died") -> bool:
        """Simulated unexpected worker death: pending calls resolve with
        ActorDiedError; a ``max_restarts != 0`` actor restarts with fresh
        state (cluster restart semantics), others die for good."""
        with self._lock:
            actor = self._actors.get(actor_id)
            if actor is None or actor.dead or actor.state == "RESTARTING":
                return False
            err = exc.ActorDiedError(actor_id, reason)
            pending = list(actor.pending_refs)
            actor.pending_refs.clear()
            restartable = actor.restarts_left != 0
            if restartable and actor.restarts_left > 0:
                actor.restarts_left -= 1
        for r in pending:
            fut = self._future_for(r.id)
            if not fut.done():
                try:
                    fut.set_result(err)
                except concurrent.futures.InvalidStateError:
                    pass
        actor._pool.shutdown(wait=False, cancel_futures=True)
        actor.death_reason = reason
        if restartable:
            self._emit_actor_event(actor_id, "RESTARTING", reason)
            actor.restart(
                on_alive=lambda: self._emit_actor_event(actor_id, "ALIVE")
            )
        else:
            actor.dead = True
            actor.state = "DEAD"
            with self._lock:
                for key, aid in list(self._named_actors.items()):
                    if aid == actor_id:
                        del self._named_actors[key]
            self._emit_actor_event(actor_id, "DEAD", reason)
        return True

    # ------------------------------------------------------------------ utils
    def _future_for(self, oid: ObjectID) -> concurrent.futures.Future:
        with self._lock:
            fut = self._objects.get(oid)
            if fut is None:
                fut = concurrent.futures.Future()
                self._objects[oid] = fut
        return fut

    def _resolve_args(self, args, kwargs):
        """Replace top-level ObjectRefs with their values (same as cluster
        dependency resolution; nested refs are passed through untouched)."""
        rargs = [self.get([a], None)[0] if isinstance(a, ObjectRef) else a for a in args]
        rkwargs = {
            k: self.get([v], None)[0] if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return rargs, rkwargs

    def _set_value(self, ref, value):
        """Idempotent store: first writer wins (a killed actor may have already
        resolved the ref with ActorDiedError)."""
        fut = self._future_for(ref.id)
        try:
            fut.set_result(value)
        except concurrent.futures.InvalidStateError:
            pass

    def _store_results(self, refs, result, num_returns):
        if num_returns == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != num_returns:
                err = exc.TaskError.from_exception(
                    ValueError(
                        f"task declared num_returns={num_returns} but returned "
                        f"{len(results)} values"
                    )
                )
                for r in refs:
                    self._set_value(r, err)
                return
        for r, v in zip(refs, results):
            self._set_value(r, v)

    def _store_error(self, refs, e: BaseException):
        err = exc.TaskError.from_exception(e)
        for r in refs:
            self._set_value(r, err)

    # ------------------------------------------------------------------ tasks
    def submit_task(self, func, args, kwargs, options: RemoteOptions):
        if options.num_returns == "streaming":
            _refuse_streaming()
        task_id = TaskID.from_random()
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i), task_id=task_id)
            for i in range(max(1, options.num_returns))
        ]

        def run():
            retries = (
                options.max_retries
                if options.max_retries is not None
                else 0 if not options.retry_exceptions else 3
            )
            attempt = 0
            while True:
                if task_id in self._cancelled:
                    self._store_error(refs, exc.TaskCancelledError(task_id))
                    return
                try:
                    rargs, rkwargs = self._resolve_args(args, kwargs)
                    result = func(*rargs, **rkwargs)
                    self._store_results(refs, result, options.num_returns)
                    return
                except Exception as e:  # noqa: BLE001 - user exception boundary
                    attempt += 1
                    if options.retry_exceptions and attempt <= retries:
                        time.sleep(backoff.delay(attempt))
                        continue
                    self._store_error(refs, e)
                    return

        threading.Thread(target=run, daemon=True, name=f"task-{task_id.hex()[:8]}").start()
        return refs

    # ----------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, options: RemoteOptions) -> ActorID:
        actor_id = ActorID.from_random()
        if options.name:
            key = (options.namespace or "default", options.name)
            with self._lock:
                if key in self._named_actors:
                    if options.get_if_exists:
                        return self._named_actors[key]
                    raise ValueError(f"actor name '{options.name}' already taken")
                self._named_actors[key] = actor_id

        def on_init_failure(actor):
            # failed construction releases the name for reuse
            with self._lock:
                for k, aid in list(self._named_actors.items()):
                    if aid == actor_id:
                        del self._named_actors[k]

        actor = _LocalActor(actor_id, options)
        self._actors[actor_id] = actor
        # async creation: dependency resolution + __init__ run on the actor's
        # own thread (the driver must not block in .remote())
        actor.start(cls, args, kwargs, self._resolve_args, on_init_failure)
        return actor_id

    def submit_actor_task(self, actor_id, method_name, args, kwargs, options):
        if options.num_returns == "streaming":
            _refuse_streaming()
        task_id = TaskID.from_random()
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i), task_id=task_id)
            for i in range(max(1, options.num_returns))
        ]
        actor = self._actors.get(actor_id)
        if actor is None or actor.dead:
            self._store_error(
                refs, exc.ActorDiedError(actor_id, getattr(actor, "death_reason", "unknown"))
            )
            return refs

        actor.pending_refs.update(refs)

        def run():
            try:
                actor.ensure_initialized()
                rargs, rkwargs = self._resolve_args(args, kwargs)
                result = getattr(actor.instance, method_name)(*rargs, **rkwargs)
                import inspect

                if inspect.iscoroutine(result):
                    import asyncio

                    result = asyncio.run(result)
                self._store_results(refs, result, options.num_returns)
            except Exception as e:  # noqa: BLE001
                self._store_error(refs, e)
            finally:
                actor.pending_refs.difference_update(refs)

        try:
            actor.submit(run)
        except RuntimeError:  # pool already shut down (actor killed concurrently)
            err = exc.ActorDiedError(actor_id, actor.death_reason)
            for r in refs:
                self._future_for(r.id).set_result(err)
            actor.pending_refs.difference_update(refs)
        return refs

    def kill_actor(self, actor_id, no_restart=True):
        # as the reference's local mode: the actor dies for good whatever
        # no_restart says (ROADMAP Queue C)
        actor = self._actors.pop(actor_id, None)
        if actor:
            actor.death_reason = "killed via ray_tpu_torch.kill"

            def resolve(pending):
                err = exc.ActorDiedError(actor_id, actor.death_reason)
                for r in pending:
                    fut = self._future_for(r.id)
                    if not fut.done():
                        fut.set_result(err)

            actor.stop(resolve_pending=resolve)
            with self._lock:
                for key, aid in list(self._named_actors.items()):
                    if aid == actor_id:
                        del self._named_actors[key]
            self._emit_actor_event(actor_id, "DEAD", actor.death_reason)

    def free_actor(self, actor_id):
        self.kill_actor(actor_id, True)

    def get_named_actor(self, name, namespace):
        key = (namespace or "default", name)
        with self._lock:
            if key not in self._named_actors:
                raise ValueError(f"Failed to look up actor '{name}'")
            return self._named_actors[key]

    # ---------------------------------------------------------------- objects
    def put(self, value) -> ObjectRef:
        oid = ObjectID.for_put(self.worker_id)
        self._future_for(oid).set_result(value)
        return ObjectRef(oid)

    def put_batch(self, values) -> List[ObjectRef]:
        """Parity with CoreWorker.put_batch (put_many): one sweep for the
        whole list, the batched code shape the cluster backend runs."""
        refs = []
        for value in values:
            oid = ObjectID.for_put(self.worker_id)
            self._future_for(oid).set_result(value)
            refs.append(ObjectRef(oid))
        return refs

    def create_deferred(self):
        oid = ObjectID.for_put(self.worker_id)
        ref = ObjectRef(oid)
        fut = self._future_for(oid)

        def fulfill(value=None, error=None):
            if error is not None:
                value = (
                    error if isinstance(error, exc.RayTpuError)
                    else exc.TaskError.from_exception(error)
                )
            try:
                fut.set_result(value)
            except concurrent.futures.InvalidStateError:
                pass

        return ref, fulfill

    def get(self, refs, timeout):
        futs = [self._future_for(r.id) for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for f in futs:
            remaining = None if deadline is None else max(0, deadline - time.monotonic())
            try:
                v = f.result(timeout=remaining)
            except concurrent.futures.TimeoutError:
                raise exc.GetTimeoutError(f"get() timed out after {timeout}s")
            if isinstance(v, exc.TaskError):
                raise v.as_instanceof_cause()
            if isinstance(v, exc.RayTpuError):
                raise v
            out.append(v)
        return out

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        futs = {r: self._future_for(r.id) for r in refs}
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        while True:
            done_now = [r for r in refs if r not in ready and futs[r].done()]
            ready.extend(done_now[: num_returns - len(ready)])
            if len(ready) >= num_returns:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            pending_futs = [futs[r] for r in refs if r not in ready]
            concurrent.futures.wait(
                pending_futs,
                timeout=remaining,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
        not_ready = [r for r in refs if r not in ready]
        return ready, not_ready

    def as_future(self, ref: ObjectRef):
        inner = self._future_for(ref.id)
        outer: concurrent.futures.Future = concurrent.futures.Future()

        def done(f):
            v = f.result()
            if isinstance(v, exc.TaskError):
                outer.set_exception(v.as_instanceof_cause())
            elif isinstance(v, exc.RayTpuError):
                outer.set_exception(v)
            else:
                outer.set_result(v)

        inner.add_done_callback(done)
        return outer

    def cancel(self, ref, force=False, recursive=False):
        if ref.task_id is not None:
            self._cancelled.add(ref.task_id)

    # ------------------------------------------------------------------ admin
    def cluster_resources(self):
        from ray_tpu_torch.core.resources import node_resources

        return node_resources()

    def available_resources(self):
        return self.cluster_resources()

    def nodes(self):
        return [
            {
                "NodeID": "local",
                "Alive": True,
                "Resources": self.cluster_resources(),
            }
        ]

    def shutdown(self):
        for a in list(self._actors.values()):
            a.stop()
        self._actors.clear()
        self._objects.clear()

"""In-process backend: tasks on daemon threads, objects in a dict of futures.

The port's copy of ray_tpu/core/local_backend.py, the LOCAL_MODE analog
(reference: python/ray/_private/worker.py mode handling). Semantics match the
cluster backend — eager async execution, futures, per-actor ordered execution,
retries — so tests written against it transfer. Objects are kept as they are
(no serialization): a CUDA tensor put or returned here is the same tensor,
on the same card, when it is read back.

Streaming generators (``num_returns="streaming"``) run on a producer
thread that pushes each item into the store as it is yielded
(ray_tpu_torch/streaming/). Tracing is the reference's: task events with
trace ids and request deadlines (an expired one is shed before user code
runs), drained into an in-process aggregator on every state query, which
backs ``state_call`` (util.state) and ``timeline``; the metrics time series
is sampled on a thread of its own. Not ported yet (ROADMAP Queue A): the
chaos plane (no injection points; ``_fail_actor``, its kill hook, stays as
the simulated worker death that restarts an actor, and fails the actor's
open streams), and the compiled graphs' entry point ``__ray_tpu_call__``
and ``actor_node``.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch import tracing
from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.backend import Backend
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.options import RemoteOptions
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.streaming import ObjectRefGenerator, StreamState
from ray_tpu_torch.util import backoff


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
        # live StreamStates of streaming method calls; failed if the actor dies
        self.pending_streams: set = set()
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
        self._lock = _san.make_lock("core.local_backend")
        self._cancelled: set = set()
        self._actor_listeners: List[Any] = []
        # tracing: local mode has no GCS — the process buffer drains into an
        # in-process aggregator on every state query (no flush thread).
        # Drop accounting is baselined at backend construction: the buffer
        # is process-global, and THIS backend's aggregator must not report
        # overflow from before it existed (same rule as the cluster flush
        # loop in tracing.events.flush_task_events_loop).
        self._events = tracing.get_buffer()
        self._events.set_identity("local", f"local-{self.worker_id.hex()[:8]}")
        self._aggregator = tracing.TaskEventAggregator()
        self._drop_baseline = self._events.dropped
        # task_id hex → task name, so a death path (which only has refs)
        # can still record a named FAILED event
        self._task_names: Dict[str, str] = {}
        # metrics time series (cluster parity: the GCS samples its merge on
        # the same period) — a daemon thread so local mode answers
        # get_metrics_timeseries with real history, making the retention
        # layer tier-1-testable
        from ray_tpu_torch.util.metrics import MetricsTimeSeries

        self._timeseries = MetricsTimeSeries()
        self._ts_stop = threading.Event()
        threading.Thread(
            target=self._timeseries_loop, daemon=True,
            name="local-metrics-ts",
        ).start()
    def _shed_expired(self, name: str, deadline: Optional[float],
                      refs=None, stream=None) -> bool:
        """Pre-execution admission (cluster worker parity): a task whose
        request deadline passed while it queued is failed typed without
        running user code. Fails `refs` or `stream` with
        DeadlineExceededError; returns True when shed."""
        if deadline is None or time.time() < deadline:
            return False
        from ray_tpu_torch.util.metrics import deadline_expired_counter

        c = deadline_expired_counter()
        if c is not None:
            c.inc(1.0, {"where": "worker"})
        err = exc.DeadlineExceededError(
            f"task {name} shed before execution: request deadline exceeded "
            f"by {time.time() - deadline:.3f}s"
        )
        if stream is not None:
            stream.fail(err)
        elif refs is not None:
            self._store_error(refs, err)
        return True

    def _timeseries_loop(self):
        from ray_tpu_torch.core.config import _config

        last = 0.0
        # short wait slices so a test shrinking metrics_report_interval_ms
        # takes effect immediately (the period is re-read every slice)
        while not self._ts_stop.wait(0.1):
            period = max(_config.metrics_report_interval_ms, 100) / 1000
            now = time.monotonic()
            if now - last < period:
                continue
            last = now
            try:
                self._timeseries.sample(self._merged_metrics())
            except Exception:  # noqa: BLE001 - sampling must never break us
                pass

    def _merged_metrics(self):
        # local mode: everything runs in-process, so the local registry IS
        # the cluster-wide view
        import time as _time

        from ray_tpu_torch.util.metrics import get_registry, merge_snapshots

        return merge_snapshots(
            {"local": (_time.time(), get_registry().collect())}
        )

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
            streams = list(actor.pending_streams)
            actor.pending_streams.clear()
            restartable = actor.restarts_left != 0
            if restartable and actor.restarts_left > 0:
                actor.restarts_left -= 1
        for st in streams:
            st.fail(err)
            self._record(st.task_id, st.name, "FAILED", actor_id=actor_id)
        for r in pending:
            fut = self._future_for(r.id)
            if not fut.done():
                try:
                    fut.set_result(err)
                except concurrent.futures.InvalidStateError:
                    pass
            if r.task_id is not None:
                # the timeline must end FAILED, never a phantom RUNNING
                self._record(r.task_id, "", "FAILED", actor_id=actor_id)
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

    # --------------------------------------------------------------- tracing
    def _record(self, task_id: TaskID, name: str, state: str,
                actor_id: Optional[ActorID] = None,
                trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        tid = task_id.hex()
        # _record runs on every task/actor thread — the name map (and its
        # eviction) must be serialized or concurrent evictions corrupt it
        with self._lock:
            if name:
                self._task_names.setdefault(tid, name)
                # bounded like the aggregator's retention: evict oldest
                # names so a long-lived local driver doesn't leak one entry
                # per task
                from ray_tpu_torch.core.config import _config

                cap = max(1000, _config.task_events_max_tasks)
                while len(self._task_names) > cap:
                    self._task_names.pop(next(iter(self._task_names)))
            else:
                name = self._task_names.get(tid, "")
        self._events.record(
            task_id=tid, name=name, state=state,
            actor_id=actor_id.hex() if actor_id else None,
            node_id="local", worker=f"local-{self.worker_id.hex()[:8]}",
            trace_id=trace_id if trace_id is not None
            else tracing.current_trace_id(),
            parent_id=parent_id, args=args,
        )

    def _sync_events(self):
        events, dropped = self._events.drain()
        self._aggregator.ingest(
            events, dropped=max(0, dropped - self._drop_baseline),
            source="local",
        )
        return self._aggregator

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

    # ---------------------------------------------------------- streaming
    def _make_stream(self, options: RemoteOptions, name: str) -> StreamState:
        from ray_tpu_torch.streaming import generator

        # no explicit window still bounds the producer's lead at the
        # pipeline cap — an unbounded producer would materialize the whole
        # stream in the backend store ahead of a slow consumer
        explicit = bool(options.generator_backpressure_num_objects)
        window = (
            options.generator_backpressure_num_objects
            or generator.MAX_INFLIGHT_ITEMS
        )
        state = StreamState(
            TaskID.from_random(), owner_addr=None, window=window, name=name,
            explicit_window=explicit,
        )
        state.set_on_close(self._reclaim_stream)
        return state

    def _reclaim_stream(self, state: StreamState) -> None:
        """Drop item futures the consumer never claimed (close/abandon)."""
        with self._lock:
            for i in range(state.consumed, state.count):
                self._objects.pop(
                    ObjectID.for_task_return(state.task_id, i), None
                )

    def _store_stream_item(self, state: StreamState, index: int, value) -> None:
        fut = self._future_for(ObjectID.for_task_return(state.task_id, index))
        try:
            fut.set_result(value)
        except concurrent.futures.InvalidStateError:
            pass

    def _drive_stream(self, state: StreamState, produce,
                      deadline: Optional[float] = None) -> None:
        """Producer loop: run the generator, publishing each item as its own
        object the moment it is yielded (push), blocking in wait_credit when
        a backpressure window is set. Mirrors the cluster worker's
        _stream_items with in-process stores."""
        if self._shed_expired(state.name, deadline, stream=state):
            self._record(state.task_id, state.name, "FAILED")
            return
        self._record(state.task_id, state.name, "RUNNING")
        with tracing.task_context(state.task_id.hex(), None,
                                  deadline=deadline):
            self._drive_stream_impl(state, produce)
        self._record(
            state.task_id, state.name,
            "FAILED" if state.error is not None else "FINISHED",
            args={"stream_items": state.count},
        )

    def _drive_stream_impl(self, state: StreamState, produce) -> None:
        from ray_tpu_torch.streaming.generator import as_item_iterator

        try:
            result = produce()
        except Exception as e:  # noqa: BLE001 - pre-yield user error: item 0
            self._store_stream_item(state, 0, exc.TaskError.from_exception(e))
            state.report_item(0, failed=True)
            state.finish(1)
            return
        it = as_item_iterator(result)
        if it is None:
            err = exc.TaskError.from_exception(TypeError(
                f"num_returns='streaming' requires a generator, got "
                f"{type(result).__name__}"
            ))
            self._store_stream_item(state, 0, err)
            state.report_item(0, failed=True)
            state.finish(1)
            return
        i = 0
        try:
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    state.finish(i)
                    return
                except Exception as e:  # noqa: BLE001 - mid-stream user exc
                    self._store_stream_item(
                        state, i, exc.TaskError.from_exception(e)
                    )
                    state.report_item(i, failed=True)
                    state.finish(i + 1)
                    return
                self._store_stream_item(state, i, item)
                state.report_item(i)
                i += 1
                # backpressure: block before producing item i while it sits
                # outside the consumer's window
                if not state.wait_credit(i):
                    # consumer closed/abandoned the stream: stop early
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
                    state.finish(i)
                    return
        except BaseException as e:  # noqa: BLE001 - never strand the consumer
            state.fail(
                e if isinstance(e, exc.RayTpuError)
                else exc.RayTpuError(f"stream producer failed: {e!r}")
            )

    def _submit_streaming_task(self, func, args, kwargs, options):
        state = self._make_stream(options, getattr(func, "__name__", "task"))
        self._record(state.task_id, state.name, "SUBMITTED",
                     parent_id=tracing.current_task_id())

        def produce():
            rargs, rkwargs = self._resolve_args(args, kwargs)
            return func(*rargs, **rkwargs)

        threading.Thread(
            target=self._drive_stream, args=(state, produce),
            kwargs={"deadline": tracing.current_deadline()}, daemon=True,
            name=f"stream-{state.task_id.hex()[:8]}",
        ).start()
        return ObjectRefGenerator(state)

    def _submit_streaming_actor_task(self, actor_id, method_name, args,
                                     kwargs, options):
        state = self._make_stream(options, method_name)
        self._record(state.task_id, method_name, "SUBMITTED",
                     actor_id=actor_id, parent_id=tracing.current_task_id())
        actor = self._actors.get(actor_id)
        if actor is None or actor.dead:
            state.fail(exc.ActorDiedError(
                actor_id, getattr(actor, "death_reason", "unknown")
            ))
            return ObjectRefGenerator(state)
        actor.pending_streams.add(state)
        deadline = tracing.current_deadline()

        def run():
            try:
                try:
                    actor.ensure_initialized()
                except BaseException as e:  # noqa: BLE001 - init failed
                    state.fail(exc.ActorDiedError(actor_id, f"init failed: {e!r}"))
                    return
                if self._shed_expired(method_name, deadline, stream=state):
                    return

                def produce():
                    rargs, rkwargs = self._resolve_args(args, kwargs)
                    return getattr(actor.instance, method_name)(
                        *rargs, **rkwargs
                    )

                self._drive_stream(state, produce, deadline=deadline)
            finally:
                actor.pending_streams.discard(state)

        try:
            actor.submit(run)
        except RuntimeError:  # pool shut down (actor killed concurrently)
            state.fail(exc.ActorDiedError(actor_id, actor.death_reason))
            actor.pending_streams.discard(state)
        return ObjectRefGenerator(state)

    # ------------------------------------------------------------------ tasks
    def submit_task(self, func, args, kwargs, options: RemoteOptions):
        if options.num_returns == "streaming":
            return self._submit_streaming_task(func, args, kwargs, options)
        task_id = TaskID.from_random()
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i), task_id=task_id)
            for i in range(max(1, options.num_returns))
        ]
        name = getattr(func, "__name__", "task")
        trace_id = tracing.current_trace_id()
        parent_id = tracing.current_task_id()
        deadline = tracing.current_deadline()
        self._record(task_id, name, "SUBMITTED", trace_id=trace_id,
                     parent_id=parent_id)

        def run():
            retries = (
                options.max_retries
                if options.max_retries is not None
                else 0 if not options.retry_exceptions else 3
            )
            attempt = 0
            with tracing.task_context(task_id.hex(), trace_id,
                                      deadline=deadline):
                if self._shed_expired(name, deadline, refs):
                    self._record(task_id, name, "FAILED", trace_id=trace_id)
                    return
                self._record(task_id, name, "RUNNING", trace_id=trace_id)
                while True:
                    if task_id in self._cancelled:
                        self._store_error(refs, exc.TaskCancelledError(task_id))
                        self._record(task_id, name, "FAILED", trace_id=trace_id)
                        return
                    try:
                        rargs, rkwargs = self._resolve_args(args, kwargs)
                        result = func(*rargs, **rkwargs)
                        self._store_results(refs, result, options.num_returns)
                        self._record(task_id, name, "FINISHED",
                                     trace_id=trace_id)
                        return
                    except Exception as e:  # noqa: BLE001 - user exception boundary
                        attempt += 1
                        if options.retry_exceptions and attempt <= retries:
                            time.sleep(backoff.delay(attempt))
                            continue
                        self._store_error(refs, e)
                        self._record(task_id, name, "FAILED", trace_id=trace_id)
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
            return self._submit_streaming_actor_task(
                actor_id, method_name, args, kwargs, options
            )
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
        trace_id = tracing.current_trace_id()
        parent_id = tracing.current_task_id()
        deadline = tracing.current_deadline()
        self._record(task_id, method_name, "SUBMITTED", actor_id=actor_id,
                     trace_id=trace_id, parent_id=parent_id)

        def run():
            try:
                actor.ensure_initialized()
                with tracing.task_context(task_id.hex(), trace_id,
                                          deadline=deadline):
                    if self._shed_expired(method_name, deadline, refs):
                        self._record(task_id, method_name, "FAILED",
                                     actor_id=actor_id, trace_id=trace_id)
                        return
                    self._record(task_id, method_name, "RUNNING",
                                 actor_id=actor_id, trace_id=trace_id)
                    rargs, rkwargs = self._resolve_args(args, kwargs)
                    result = getattr(actor.instance, method_name)(
                        *rargs, **rkwargs
                    )
                    import inspect

                    if inspect.iscoroutine(result):
                        import asyncio

                        result = asyncio.run(result)
                self._store_results(refs, result, options.num_returns)
                self._record(task_id, method_name, "FINISHED",
                             actor_id=actor_id, trace_id=trace_id)
            except Exception as e:  # noqa: BLE001
                self._store_error(refs, e)
                self._record(task_id, method_name, "FAILED",
                             actor_id=actor_id, trace_id=trace_id)
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
            for st in list(actor.pending_streams):
                st.fail(exc.ActorDiedError(actor_id, actor.death_reason))
            actor.pending_streams.clear()

            def resolve(pending):
                err = exc.ActorDiedError(actor_id, actor.death_reason)
                for r in pending:
                    fut = self._future_for(r.id)
                    if not fut.done():
                        fut.set_result(err)
                        if r.task_id is not None:
                            self._record(r.task_id, "", "FAILED",
                                         actor_id=actor_id)

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

    def state_call(self, method, **kwargs):
        """Local-mode backing for util.state (no GCS process)."""
        if method == "get_nodes":
            return self.nodes()
        if method == "list_actors":
            return [
                {"actor_id": aid.binary(), "state": "ALIVE"}
                for aid, a in self._actors.items()
            ]
        if method == "list_tasks":
            return self._sync_events().list_tasks(kwargs.get("limit", 1000))
        if method == "get_task":
            return self._sync_events().get_task(kwargs["task_id"])
        if method == "summarize_tasks":
            return self._sync_events().summarize()
        if method == "timeline_events":
            return self._sync_events().timeline_events(
                kwargs.get("limit", 50_000)
            )
        if method in ("list_placement_groups", "object_stats"):
            return []
        if method == "get_metrics":
            m = {"num_nodes": 1, "num_alive_nodes": 1,
                 "num_actors": len(self._actors)}
            m.update(self._sync_events().stats())
            return m
        if method == "collect_metrics":
            return self._merged_metrics()
        if method == "get_metrics_timeseries":
            # append a fresh sample to the RESULT (not the ring) so a
            # just-recorded metric is queryable without waiting out the
            # sampling period — polling queries must not evict the ring's
            # periodic history (the cluster-mode retention contract)
            import time as _time

            names = kwargs.get("names")
            limit = kwargs.get("limit")
            out = self._timeseries.query(names=names, limit=limit)
            series = self._merged_metrics()
            if names is not None:
                keep = set(names)
                series = [s for s in series if s["name"] in keep]
            out = out + [{"ts": _time.time(), "series": series}]
            # the fresh sample counts toward the limit: both backends
            # honor "at most `limit` samples" (limit=0 means none)
            if limit is None:
                return out
            limit = int(limit)
            return out[-limit:] if limit > 0 else []
        raise ValueError(f"unknown state method {method!r}")

    def shutdown(self):
        self._ts_stop.set()
        for a in list(self._actors.values()):
            a.stop()
        self._actors.clear()
        self._objects.clear()

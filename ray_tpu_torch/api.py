"""Top-level API: init/shutdown/remote/get/put/wait/kill/cancel/get_actor.

The port's copy of ray_tpu/api.py. ``init()`` starts a one-node cluster of
subprocesses (GCS, raylet, worker processes); ``init("host:port")`` joins
one from another driver on the same host; ``init(local_mode=True)`` or
``RAY_TPU_LOCAL_MODE=1`` run the in-process runtime; ``init("ray://...")``
connects a thin client to a ``ClientServer`` (client/). ``timeline``
exports the task events of ``tracing/`` as a Chrome trace.
Parity: python/ray/_private/worker.py — `init` (:1106), `get` (:2409), `put`
(:2524), `wait` (:2587); a process-global Worker singleton holds the active
backend. In cluster mode this process is the *driver* (drivers are workers too).
"""

from __future__ import annotations

import atexit
import inspect
import os
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.backend import Backend
from ray_tpu_torch.core.options import RemoteOptions, options_from_kwargs
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction


class Worker:
    """Process-global runtime context (driver or worker)."""

    def __init__(self):
        self.backend: Optional[Backend] = None
        self.mode: Optional[str] = None  # "local" | "cluster" | "worker"
        self.namespace: str = "default"

    @property
    def connected(self):
        return self.backend is not None


_worker = Worker()
_init_lock = _san.make_lock("api.init")


def _global_worker() -> Worker:
    return _worker


def is_initialized() -> bool:
    return _worker.connected


def _auto_init():
    if not _worker.connected:
        init()


def init(
    address: Optional[str] = None,
    *,
    local_mode: Optional[bool] = None,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _node_name: Optional[str] = None,
) -> "Worker":
    """Start (or connect to) a ray_tpu_torch cluster.

    - ``address=None``: start a fresh single-node cluster in subprocesses
      (GCS + raylet + workers), like the reference's `ray.init()`. The
      node advertises the cards this process sees (``GPU`` and
      ``GPU-<kind>``); ``num_gpus`` overrides the count.
    - ``address="host:port"``: connect this driver to an existing GCS on
      this host (the token comes from the file the starting driver wrote).
    - ``address="ray://host:port"``: a thin client; every call proxies to
      the ``ClientServer`` (client/server.py) at that address.
    - ``local_mode=True``: no processes; run tasks on threads in-process.

    ``_node_name`` pins the driver to that raylet's node (and shm
    session). ``num_cpus``, ``num_gpus``,
    ``resources``, ``object_store_memory`` and ``log_to_driver`` configure
    a started cluster; local mode ignores them, as the reference's does.
    """
    with _init_lock:
        if _worker.connected:
            if ignore_reinit_error:
                return _worker
            raise RuntimeError("ray_tpu_torch.init() called twice (pass ignore_reinit_error=True)")
        if local_mode is None:
            local_mode = os.environ.get("RAY_TPU_LOCAL_MODE", "0") == "1"
        if namespace:
            _worker.namespace = namespace
        if address and address.startswith("ray://"):
            # thin client: proxy everything to a ClientServer on the head
            # (parity: ray.init("ray://...") → util/client/worker.py:81)
            from ray_tpu_torch.client import ClientBackend

            _worker.backend = ClientBackend(address)
            _worker.mode = "client"
        elif local_mode:
            from ray_tpu_torch.core.local_backend import LocalBackend

            _worker.backend = LocalBackend()
            _worker.mode = "local"
        else:
            from ray_tpu_torch.core.cluster_backend import ClusterBackend

            _worker.backend = ClusterBackend(
                address=address,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                object_store_memory=object_store_memory,
                node_name=_node_name,
                log_to_driver=log_to_driver,
            )
            _worker.mode = "cluster"
        atexit.register(shutdown)
        return _worker


def shutdown():
    with _init_lock:
        if _worker.backend is not None:
            try:
                _worker.backend.shutdown()
            finally:
                _worker.backend = None
                _worker.mode = None


def remote(*args, **kwargs):
    """@ray_tpu_torch.remote decorator for functions and classes."""

    def make(target):
        if inspect.isclass(target):
            opts = options_from_kwargs(True, **kwargs)
            if opts.max_restarts is None:
                opts.max_restarts = 0
            return ActorClass(target, opts)
        opts = options_from_kwargs(False, **kwargs)
        return RemoteFunction(target, opts)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return make


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    _auto_init()
    return _worker.backend.put(value)


def put_many(values: Sequence[Any]) -> List[ObjectRef]:
    """Batched put: one bookkeeping sweep for the whole list (dispatch-plane
    batching; the cluster backend coalesces location records into a single
    flush). Semantically identical to ``[put(v) for v in values]``."""
    values = list(values)
    for v in values:
        if isinstance(v, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
    _auto_init()
    return list(_worker.backend.put_batch(values))


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None
):
    _auto_init()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = _worker.backend.get(ref_list, timeout)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    _auto_init()
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return _worker.backend.wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _auto_init()
    _worker.backend.kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    _auto_init()
    _worker.backend.cancel(ref, force, recursive)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    _auto_init()
    actor_id = _worker.backend.get_named_actor(name, namespace or _worker.namespace)
    return ActorHandle(actor_id, RemoteOptions(), owned=False)


def cluster_resources() -> Dict[str, float]:
    _auto_init()
    return _worker.backend.cluster_resources()


def available_resources() -> Dict[str, float]:
    _auto_init()
    return _worker.backend.available_resources()


def nodes() -> List[dict]:
    _auto_init()
    return _worker.backend.nodes()


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace export of task execution (parity: ray.timeline,
    python/ray/_private/state.py), backed by the tracing subsystem
    (ray_tpu_torch/tracing/): one trace-process row per node, one thread row per
    worker; RUNNING→EXECUTED/FINISHED/FAILED pairs render as complete ("X")
    slices, other lifecycle transitions as instants, profile_span() spans
    as slices on the worker that recorded them. Open the file in
    chrome://tracing or Perfetto. Returns the event list; also writes JSON
    when `filename` is given."""
    import json

    from ray_tpu_torch.tracing import build_chrome_trace
    from ray_tpu_torch.util.state import timeline_events

    out = build_chrome_trace(timeline_events())
    if filename:
        with open(filename, "w") as f:
            json.dump(out, f)
    return out

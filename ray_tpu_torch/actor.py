"""Actor API: @ray_tpu_torch.remote on classes → ActorClass / ActorHandle / ActorMethod.

The port's copy of ray_tpu/actor.py; ``.bind()`` (DAG composition) raises
NotImplementedError until the dag and cgraph planes are ported.
Parity: python/ray/actor.py — ActorClass._remote creates the actor through the
backend (reference: GCS actor manager, §3.3 of SURVEY); ActorHandle pickles by
actor id so handles can be passed into tasks; method calls are ordered per actor.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.options import RemoteOptions
from ray_tpu_torch.remote_function import _refuse_dag


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns=1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            "use .remote()"
        )

    def options(self, **kwargs) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name, self._num_returns)
        m._call_options = kwargs
        return m

    def bind(self, *args, **kwargs):
        """DAG composition from a live handle: not ported yet."""
        _refuse_dag()

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.api import _global_worker

        call_opts = dict(getattr(self, "_call_options", {}))
        call_opts.setdefault("num_returns", self._num_returns)
        opts = self._handle._options.merged_with(**call_opts)
        backend = _global_worker().backend
        if opts.num_returns == "streaming":
            # backend returns an ObjectRefGenerator (push-based per-item refs)
            return backend.submit_actor_task(
                self._handle._actor_id, self._method_name, args, kwargs, opts
            )
        refs = backend.submit_actor_task(
            self._handle._actor_id, self._method_name, args, kwargs, opts
        )
        if opts.num_returns == 1:
            return refs[0]
        if opts.num_returns == 0:
            return None
        return list(refs)


class ActorHandle:
    def __init__(
        self,
        actor_id: ActorID,
        options: RemoteOptions,
        owned: bool = False,
        method_num_returns: Optional[dict] = None,
    ):
        self._actor_id = actor_id
        self._options = options.merged_with(num_returns=1)
        # only the original creating handle triggers out-of-scope teardown
        self._owned = owned
        self._method_num_returns = method_num_returns or {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name, self._method_num_returns.get(name, 1))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"

    def __reduce__(self):
        return (
            _rebuild_handle,
            (self._actor_id, self._options, self._method_num_returns),
        )

    def __del__(self):
        if getattr(self, "_owned", False) and self._options.lifetime != "detached":
            try:
                from ray_tpu_torch.api import _global_worker, is_initialized

                if is_initialized():
                    _global_worker().backend.free_actor(self._actor_id)
            except Exception:  # interpreter shutdown
                pass


def _rebuild_handle(actor_id, options, method_num_returns=None):
    return ActorHandle(actor_id, options, owned=False, method_num_returns=method_num_returns)


class ActorClass:
    def __init__(self, cls, options: RemoteOptions):
        self._cls = cls
        self._default_options = options
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            "use .remote()"
        )

    def options(self, **kwargs) -> "ActorClass":
        return ActorClass(self._cls, self._default_options.merged_with(**kwargs))

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.api import _auto_init, _global_worker

        _auto_init()
        backend = _global_worker().backend
        actor_id = backend.create_actor(
            self._cls, args, kwargs, self._default_options
        )
        method_num_returns = {
            name: getattr(m, "__ray_tpu_num_returns__")
            for name, m in vars(self._cls).items()
            if callable(m) and hasattr(m, "__ray_tpu_num_returns__")
        }
        return ActorHandle(
            actor_id,
            self._default_options,
            owned=True,
            method_num_returns=method_num_returns,
        )

    def bind(self, *args, **kwargs):
        _refuse_dag()


def method(num_returns=1):
    """Decorator to annotate actor methods (reference: ray.method).
    ``num_returns`` accepts an int or ``"streaming"`` for generator methods
    whose calls return an ObjectRefGenerator."""

    def decorator(f):
        f.__ray_tpu_num_returns__ = num_returns
        return f

    return decorator

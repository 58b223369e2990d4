"""@ray_tpu_torch.remote for functions.

The port's copy of ray_tpu/remote_function.py. ``.bind()`` (DAG
composition) needs the dag and cgraph planes, not ported yet, and raises
NotImplementedError.
Parity: python/ray/remote_function.py:245 (`RemoteFunction._remote`) — options
merging, num_returns handling, submission through the active backend.
"""

from __future__ import annotations

import functools
from typing import Any

from ray_tpu_torch.core.options import RemoteOptions, options_from_kwargs


class RemoteFunction:
    def __init__(self, func, options: RemoteOptions):
        self._function = func
        self._default_options = options
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._function, '__name__', '?')}' cannot be "
            "called directly; use .remote()"
        )

    def options(self, **kwargs) -> "RemoteFunction":
        merged = self._default_options.merged_with(**kwargs)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def _remote(self, args, kwargs, options: RemoteOptions):
        from ray_tpu_torch.api import _auto_init, _global_worker

        _auto_init()
        backend = _global_worker().backend
        if options.num_returns == "streaming":
            # backend returns an ObjectRefGenerator (push-based per-item refs)
            return backend.submit_task(self._function, args, kwargs, options)
        refs = backend.submit_task(self._function, args, kwargs, options)
        if options.num_returns == 1:
            return refs[0]
        if options.num_returns == 0:
            return None
        return list(refs)

    @property
    def bound(self):
        """For DAG composition (serve deployment graphs): not ported yet."""
        _refuse_dag()

    def bind(self, *args, **kwargs):
        _refuse_dag()


def _refuse_dag():
    raise NotImplementedError(
        ".bind() composes a DAG, which needs the dag and cgraph planes; "
        "they are not ported yet (ROADMAP Queue A: cgraph, Serve, Tune's "
        "controller, workflow)"
    )

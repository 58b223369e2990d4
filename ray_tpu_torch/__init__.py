"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The device plane is PyTorch on one H100: plain tensor code in PyTorch and
every kernel that ray_tpu wrote in Pallas for the TPU rewritten by hand for
sm_90a (ops/csrc/). Module paths and function names follow ray_tpu so each
module's counterpart is easy to find. The package imports nothing of JAX
or of ray_tpu; entry points run on the card unless the caller passes
device="cpu", where every kernel wrapper uses its plain PyTorch version.

The runtime's API (init, remote, get, put, wait, actors...) is ray_tpu's:
``init()`` starts a one-node cluster of processes, ``init(local_mode=True)``
runs in-process; see api.py.
"""

from ray_tpu_torch._version import __version__

# The API is imported on first use, not here: the runtime's daemons run as
# ``python -m ray_tpu_torch.core.…``, which imports this package first, and
# the GCS and the raylet must not pay for importing torch.
_EXPORTS = {
    "method": "ray_tpu_torch.actor",
    "available_resources": "ray_tpu_torch.api",
    "cancel": "ray_tpu_torch.api",
    "cluster_resources": "ray_tpu_torch.api",
    "get": "ray_tpu_torch.api",
    "get_actor": "ray_tpu_torch.api",
    "init": "ray_tpu_torch.api",
    "is_initialized": "ray_tpu_torch.api",
    "kill": "ray_tpu_torch.api",
    "nodes": "ray_tpu_torch.api",
    "put": "ray_tpu_torch.api",
    "put_many": "ray_tpu_torch.api",
    "remote": "ray_tpu_torch.api",
    "shutdown": "ray_tpu_torch.api",
    "wait": "ray_tpu_torch.api",
    "_config": "ray_tpu_torch.core.config",
    "ObjectRef": "ray_tpu_torch.core.refs",
    "ObjectRefGenerator": "ray_tpu_torch.streaming",
    "timeline": "ray_tpu_torch.api",
    "profile_span": "ray_tpu_torch.tracing",
    "remaining_time_s": "ray_tpu_torch.tracing",
}


def __getattr__(name):
    import importlib

    if name in ("exceptions", "tracing"):
        value = importlib.import_module(f"ray_tpu_torch.{name}")
    elif name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    else:
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "put_many",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "cluster_resources",
    "available_resources",
    "nodes",
    "timeline",
    "ObjectRef",
    "ObjectRefGenerator",
    "exceptions",
    "tracing",
    "profile_span",
    "remaining_time_s",
]

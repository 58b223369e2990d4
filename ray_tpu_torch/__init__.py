"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The device plane is PyTorch on one H100: plain tensor code in PyTorch and
every kernel that ray_tpu wrote in Pallas for the TPU rewritten by hand for
sm_90a (ops/csrc/). Module paths and function names follow ray_tpu so each
module's counterpart is easy to find. The package imports nothing of JAX
or of ray_tpu; entry points run on the card unless the caller passes
device="cpu", where every kernel wrapper uses its plain PyTorch version.

The runtime's API (init, remote, get, put, wait, actors...) is ray_tpu's
in-process mode: ``init(local_mode=True)``; see api.py.
"""

import torch as _torch

# MKL's vector math, which torch.exp, tanh, log, sin ... of a float CPU
# tensor call in 2048-element chunks over the intra-op threads, can get
# its first call in a process wrong when several threads make it at once:
# some threads' chunks come back good to only about 1e-4 relative, and
# every later call is exact (seen in about 3 % of fresh processes that had
# imported JAX first). One call on this thread first sets it up for the
# whole process, so the port's first call equals its second.
_torch.exp(_torch.zeros(1))

from ray_tpu_torch._version import __version__  # noqa: E402
from ray_tpu_torch.actor import method  # noqa: E402
from ray_tpu_torch.api import (  # noqa: E402
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    put_many,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.config import _config  # noqa: E402
from ray_tpu_torch.core.refs import ObjectRef  # noqa: E402
from ray_tpu_torch import exceptions  # noqa: E402

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
    "ObjectRef",
    "exceptions",
]

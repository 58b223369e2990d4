"""Resource model: CPUs, memory and NVIDIA GPUs.

The port's copy of ray_tpu/core/resources.py with GPUs in the TPUs' place:
``ResourceSet`` and its fixed-point arithmetic are unchanged; a node
reports ``GPU`` (the card count) plus a ``GPU-<kind>`` resource (e.g.
``GPU-nvidia-h100-80gb-hbm3``), the counterpart of ``TPU``/``TPU-<kind>``:
the count from torch.cuda, the kind from NVML, so that detecting them opens
no CUDA context. The ICI-slice labels and the GKE TPU env vars have no
counterpart here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

# Fractional resources use fixed-point arithmetic to avoid float drift, mirroring
# the reference's FixedPoint (src/ray/raylet/scheduling/fixed_point.h).
RESOURCE_UNIT = 10_000


def to_fixed(v: float) -> int:
    return int(round(v * RESOURCE_UNIT))


def from_fixed(v: int) -> float:
    return v / RESOURCE_UNIT


class ResourceSet:
    """A bag of named resource quantities with fixed-point internal storage."""

    __slots__ = ("_amounts",)

    def __init__(self, amounts: Optional[Dict[str, float]] = None, _fixed=None):
        if _fixed is not None:
            self._amounts = dict(_fixed)
        else:
            self._amounts = {
                k: to_fixed(v) for k, v in (amounts or {}).items() if v != 0
            }

    @staticmethod
    def from_fixed_dict(d: Dict[str, int]) -> "ResourceSet":
        return ResourceSet(_fixed={k: v for k, v in d.items() if v != 0})

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._amounts.items()}

    def fixed(self) -> Dict[str, int]:
        return dict(self._amounts)

    def get(self, name: str) -> float:
        return from_fixed(self._amounts.get(name, 0))

    def is_empty(self) -> bool:
        return not self._amounts

    def fits(self, other: "ResourceSet") -> bool:
        """True if `other` (a demand) fits within self (availability)."""
        return all(self._amounts.get(k, 0) >= v for k, v in other._amounts.items())

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet.from_fixed_dict(out)

    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet.from_fixed_dict(out)

    def utilization(self, total: "ResourceSet") -> float:
        """Max fractional utilization across resources present in `total`."""
        utils = []
        for k, tot in total._amounts.items():
            if tot <= 0:
                continue
            avail = self._amounts.get(k, 0)
            utils.append(1.0 - avail / tot)
        return max(utils) if utils else 0.0

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and other._amounts == self._amounts

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


def _nvml_device_name() -> Optional[str]:
    """The name NVML gives the first visible card (CUDA_VISIBLE_DEVICES'
    first entry, an index or a UUID), or None where NVML cannot say.
    Reading it creates no CUDA context."""
    import ctypes

    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        handle = ctypes.c_void_p()
        if first.startswith(("GPU-", "MIG-")):
            rc = nvml.nvmlDeviceGetHandleByUUID(first.encode(), ctypes.byref(handle))
        elif first.isdigit():
            rc = nvml.nvmlDeviceGetHandleByIndex_v2(int(first), ctypes.byref(handle))
        else:
            return None
        name = ctypes.create_string_buffer(96)
        if rc != 0 or nvml.nvmlDeviceGetName(handle, name, len(name)) != 0:
            return None
        return name.value.decode()
    finally:
        nvml.nvmlShutdown()


def detect_gpu_resources() -> Dict[str, float]:
    """The local CUDA cards and their kind. Safe to call without a card,
    and initialises CUDA in no process: the count comes from
    torch.cuda.device_count() (none where torch.cuda.is_available() is
    false: a CPU build of torch, no card, or CUDA_VISIBLE_DEVICES=""), the
    kind from NVML. Where NVML cannot name the card, ``GPU-<kind>`` is left
    out."""
    import torch

    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    n = torch.cuda.device_count()
    if n:
        out["GPU"] = float(n)
        name = _nvml_device_name()
        if name:
            out[f"GPU-{name.lower().replace(' ', '-')}"] = float(n)
    return out


def node_resources(
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    memory_mb: Optional[int] = None,
    custom: Optional[Dict[str, float]] = None,
    detect_gpus: bool = True,
) -> Dict[str, float]:
    """Build the resource dict a node advertises on registration."""
    res: Dict[str, float] = {}
    res["CPU"] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    if num_gpus is not None:
        res["GPU"] = float(num_gpus)
    elif detect_gpus:
        res.update(detect_gpu_resources())
    if memory_mb is None:
        try:
            import psutil

            memory_mb = int(psutil.virtual_memory().total / (1024 * 1024) * 0.7)
        except ImportError:  # pragma: no cover
            memory_mb = 4096
    res["memory"] = float(memory_mb)
    if custom:
        res.update(custom)
    return res

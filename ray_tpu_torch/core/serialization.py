"""Serialization: cloudpickle + pickle-protocol-5 out-of-band buffers.

The port's copy of ray_tpu/core/serialization.py, with torch tensors where
the reference has jax.Arrays.
Parity: the reference serializes with vendored cloudpickle and moves large numpy /
Arrow buffers out-of-band so they land in plasma with zero copies
(python/ray/_private/serialization.py). We do the same with stock cloudpickle:
``serialize`` returns a small in-band payload plus a list of raw buffers; the object
store writes buffers contiguously into shared memory and ``deserialize`` maps them
back with zero copies (numpy arrays reconstruct over the shm pages).

Torch tensors: a CUDA tensor is copied to the host once (``.cpu()``, the
counterpart of ``jax.device_get``) and deserializes to a CPU tensor of the
same dtype, shape and strides; the consumer decides whether to move it
onto a card. An ``nn.Parameter`` comes back a Parameter and a leaf tensor
keeps its requires_grad, so a module or an optimizer's parameters still
train after the trip. A CPU tensor travels as the bytes of the storage span its
view covers, one protocol-5 buffer (out of band from 64 KiB, as numpy's),
with no copy into the payload. The in-process runtime passes objects by
reference and serializes nothing: this module serves the explicit API
(``serialize``/``dumps``) now and the multi-process runtime next.
"""

from __future__ import annotations

import io
import pickle
import threading
import types
from typing import Any, Dict, List

import cloudpickle
import torch

from ray_tpu_torch.core.refs import ObjectRef


def user_module_for_by_value(obj):
    """If ``obj`` is a function/class from a module workers likely can't import
    (user scripts, test files), return that module so it can be registered for
    by-value pickling; installed packages, stdlib and ray_tpu_torch itself
    pickle by reference. Mirrors the reference's function-export semantics
    (python/ray/_private/function_manager.py) for task/actor *arguments* too.
    """
    import sys
    import sysconfig

    if not isinstance(obj, (types.FunctionType, type)):
        return None
    mod_name = getattr(obj, "__module__", "") or ""
    if mod_name in ("", "__main__", "builtins"):
        return None
    mod = sys.modules.get(mod_name)
    if mod is None:
        return None
    f = getattr(mod, "__file__", "") or ""
    stdlib = sysconfig.get_paths().get("stdlib", "//")
    if (
        not f
        or "site-packages" in f
        or "dist-packages" in f
        or f.startswith(stdlib)
        or "/ray_tpu_torch/" in f.replace("\\", "/")
    ):
        return None
    return mod

# Buffers smaller than this stay in-band (copying beats bookkeeping).
_OOB_THRESHOLD = 1 << 16  # 64 KiB


class SerializedObject:
    __slots__ = ("payload", "buffers", "contained_refs")

    def __init__(self, payload: bytes, buffers: List[memoryview], contained_refs):
        self.payload = payload
        self.buffers = buffers
        self.contained_refs = contained_refs

    def total_bytes(self) -> int:
        return len(self.payload) + sum(b.nbytes for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten to a single framed byte string (for wire transfer / shm)."""
        out = io.BytesIO()
        out.write(len(self.payload).to_bytes(8, "little"))
        out.write(len(self.buffers).to_bytes(4, "little"))
        for b in self.buffers:
            out.write(b.nbytes.to_bytes(8, "little"))
        out.write(self.payload)
        for b in self.buffers:
            out.write(b)
        return out.getvalue()

    @staticmethod
    def from_buffer(data) -> "SerializedObject":
        """Zero-copy parse of the framing produced by ``to_bytes``.

        ``data`` may be bytes or a writable/readable memoryview over shared memory;
        the returned buffers are sub-views, not copies.
        """
        mv = memoryview(data)
        plen = int.from_bytes(mv[:8], "little")
        nbuf = int.from_bytes(mv[8:12], "little")
        off = 12
        sizes = []
        for _ in range(nbuf):
            sizes.append(int.from_bytes(mv[off : off + 8], "little"))
            off += 8
        payload = bytes(mv[off : off + plen])
        off += plen
        buffers = []
        for s in sizes:
            buffers.append(mv[off : off + s])
            off += s
        return SerializedObject(payload, buffers, [])


def _device_get_if_torch(value):
    """A CUDA tensor → its host copy (HBM → host before the bytes are
    written out), made once; anything else as it is."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return value.detach().cpu()
    return value


def _tensor_reduce(t):
    """(rebuild, args) of a tensor or ``nn.Parameter``: its host copy's
    storage span, from the view's first element to its last, as one
    protocol-5 buffer of bytes, with its dtype, shape and strides (the view
    starts at the span's first byte); a CUDA tensor is copied to the host
    once here. A Parameter comes back a Parameter with its requires_grad,
    a leaf tensor with its requires_grad; a non-leaf tensor comes back
    detached (autograd's graph does not travel)."""
    requires_grad = t.requires_grad and t.is_leaf
    is_param = isinstance(t, torch.nn.Parameter)
    t = _device_get_if_torch(t.detach()).resolve_conj().resolve_neg()
    shape, stride = tuple(t.shape), tuple(t.stride())
    if t.numel() == 0:
        buf = b""
    else:
        span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        flat = t.as_strided((span,), (1,), t.storage_offset())
        buf = pickle.PickleBuffer(flat.view(torch.uint8).numpy())
    return _restore_tensor, (buf, str(t.dtype), shape, stride, requires_grad,
                             is_param)


def _restore_tensor(buf, dtype_name, shape, stride, requires_grad, is_param):
    """A CPU tensor over `buf` (copied first only when the buffer is
    read-only, as bytes and views over them are: torch has no read-only
    tensor)."""
    dtype = getattr(torch, dtype_name.rsplit(".", 1)[-1])
    mv = memoryview(buf)
    if not mv.nbytes:
        t = torch.empty_strided(shape, stride, dtype=dtype)
    else:
        if mv.readonly:
            mv = memoryview(bytearray(mv))
        flat = torch.frombuffer(mv, dtype=torch.uint8).view(dtype)
        t = flat.as_strided(shape, stride)
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


# cloudpickle.register_pickle_by_value mutates process-global state; concurrent
# serialize() calls must not unregister a module while another dump is mid-
# flight (advisor finding r2). Registrations are reference-counted under a lock.
_BY_VALUE_LOCK = threading.Lock()
_BY_VALUE_COUNTS: Dict[str, int] = {}


def _register_by_value(mod) -> bool:
    with _BY_VALUE_LOCK:
        n = _BY_VALUE_COUNTS.get(mod.__name__, 0)
        if n == 0:
            try:
                cloudpickle.register_pickle_by_value(mod)
            except Exception:  # noqa: BLE001 - fall back to by-reference
                return False
        _BY_VALUE_COUNTS[mod.__name__] = n + 1
        return True


def _unregister_by_value(mod) -> None:
    with _BY_VALUE_LOCK:
        n = _BY_VALUE_COUNTS.get(mod.__name__, 0)
        if n <= 1:
            _BY_VALUE_COUNTS.pop(mod.__name__, None)
            try:
                cloudpickle.unregister_pickle_by_value(mod)
            except Exception:  # noqa: BLE001
                pass
        else:
            _BY_VALUE_COUNTS[mod.__name__] = n - 1


class _FrameworkPickler(cloudpickle.CloudPickler):
    """Per-call pickler. Deliberately a MODULE-level class: a class defined
    inside serialize() sits in a reference cycle (class → methods → closure
    cells → contained_refs/buffers), so every serialized ObjectRef and
    out-of-band buffer stayed alive until a gen-2 GC — which kept 'dead'
    refs counted in the owner and deferred distributed frees indefinitely."""

    def __init__(self, file, buffer_callback, contained_refs, registered_mods,
                 registered_names):
        # buffer_callback must be a plain function, NOT a bound method of
        # self — the C pickler holding a bound method closes a cycle
        # (pickler → method → pickler) that defers teardown to gen-2 GC,
        # which is exactly the retention this class exists to avoid.
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self._contained_refs = contained_refs
        self._registered_mods = registered_mods
        self._registered_names = registered_names

    def persistent_id(self, obj):
        return None

    def reducer_override(self, obj):
        if isinstance(obj, ObjectRef):
            self._contained_refs.append(obj)
        if type(obj) in (torch.Tensor, torch.nn.Parameter):
            # Other Tensor subclasses keep torch's own reducer.
            return _tensor_reduce(obj)
        # Functions/classes from user modules (test files, scripts) must
        # travel by VALUE — the worker can't import their module. Register
        # the module before delegating so cloudpickle's own reduce path
        # sees it in the by-value registry.
        mod = user_module_for_by_value(obj)
        if mod is not None and mod.__name__ not in self._registered_names:
            if _register_by_value(mod):
                self._registered_mods.append(mod)
                self._registered_names.add(mod.__name__)
        # Delegate to cloudpickle so locally-defined / unimportable functions
        # and classes are still pickled by value (the whole point of using
        # CloudPickler); returning NotImplemented here would silently fall
        # back to stdlib pickle for them.
        return super().reducer_override(obj)


def serialize(value: Any) -> SerializedObject:
    buffers: List[memoryview] = []
    contained_refs: List[ObjectRef] = []
    registered_mods: List[Any] = []

    def _buffer_cb(buf: pickle.PickleBuffer):
        raw = buf.raw()
        if raw.nbytes < _OOB_THRESHOLD:
            return True  # keep in-band
        buffers.append(raw)
        return False

    out = io.BytesIO()
    p = _FrameworkPickler(out, _buffer_cb, contained_refs, registered_mods,
                          set())
    try:
        p.dump(value)
    finally:
        for mod in registered_mods:
            _unregister_by_value(mod)
    return SerializedObject(out.getvalue(), buffers, contained_refs)


def deserialize(obj: SerializedObject) -> Any:
    return pickle.loads(obj.payload, buffers=obj.buffers)


def dumps(value: Any) -> bytes:
    """One-shot serialize to a flat byte string."""
    return serialize(value).to_bytes()


def loads(data) -> Any:
    return deserialize(SerializedObject.from_buffer(data))

"""ObjectRef — a future/handle to an immutable object in the cluster.

Parity: the reference's ``ObjectRef`` (python/ray/includes/object_ref.pxi) is a thin
wrapper over a binary id plus the owner's address; `ray.get` resolves it through the
owner. Ours carries the ObjectID and the owner's (node, worker) addresses so any
process can resolve it without a central directory — the *owner* serves locations
(ownership model of src/ray/core_worker/reference_count.h:61).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.ids import ObjectID, TaskID

# ---------------------------------------------------------------------------
# Process-local reference registry (the Python half of distributed
# refcounting, reference_count.h:61): counts live ObjectRef instances per
# object id in THIS process. When the count drops to zero the registered
# callback fires — the owner uses it to free the object cluster-wide once
# no pending tasks/borrowers remain; borrowers use it to send a release to
# the owner (core_worker._on_local_refs_zero).
# ---------------------------------------------------------------------------
_reg_lock = _san.make_lock("core.refs")
_local_counts: Dict[bytes, int] = {}
_owner_addrs: Dict[bytes, Optional[str]] = {}  # last-seen owner per live oid
_on_zero: Optional[Callable[[ObjectID, Optional[str], Optional[TaskID]], None]] = None


def set_on_zero_callback(
    cb: Optional[Callable[[ObjectID, Optional[str], Optional[TaskID]], None]],
) -> None:
    global _on_zero
    _on_zero = cb


def local_ref_count(oid_bytes: bytes) -> int:
    with _reg_lock:
        return _local_counts.get(oid_bytes, 0)


def live_refs() -> Dict[bytes, Optional[str]]:
    """Snapshot of live oids → owner_addr in this process (borrow scan)."""
    with _reg_lock:
        return dict(_owner_addrs)


class ObjectRef:
    __slots__ = (
        "id", "owner_addr", "task_id", "_in_band_value", "_has_in_band",
        "__weakref__",
    )

    def __init__(
        self,
        object_id: ObjectID,
        owner_addr: Optional[str] = None,
        task_id: Optional[TaskID] = None,
    ):
        self.id = object_id
        self.owner_addr = owner_addr  # "host:port" of owning worker's RPC endpoint
        self.task_id = task_id  # creating task (for lineage reconstruction)
        self._in_band_value = None
        self._has_in_band = False
        with _reg_lock:
            key = object_id.binary()
            _local_counts[key] = _local_counts.get(key, 0) + 1
            if owner_addr is not None or key not in _owner_addrs:
                _owner_addrs[key] = owner_addr

    def __del__(self):
        try:
            key = self.id.binary()
            with _reg_lock:
                n = _local_counts.get(key, 0) - 1
                if n <= 0:
                    _local_counts.pop(key, None)
                    _owner_addrs.pop(key, None)
                else:
                    _local_counts[key] = n
            if n <= 0 and _on_zero is not None:
                _on_zero(self.id, self.owner_addr, self.task_id)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        # in-band value deliberately not pickled: receivers resolve via the owner.
        return (_rebuild_ref, (self.id, self.owner_addr, self.task_id))

    # -- convenience -------------------------------------------------------
    def future(self):
        """Return a concurrent.futures.Future resolving to the object value."""
        from ray_tpu_torch.api import _global_worker

        return _global_worker().backend.as_future(self)

    def __await__(self):
        import asyncio

        from ray_tpu_torch.api import _global_worker

        backend = _global_worker().backend
        return asyncio.wrap_future(backend.as_future(self)).__await__()


def _rebuild_ref(object_id, owner_addr, task_id):
    return ObjectRef(object_id, owner_addr, task_id)

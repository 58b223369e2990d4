"""Unique identifiers for objects, tasks, actors, nodes, jobs, placement groups.

The port's copy of ray_tpu/core/ids.py, unchanged.

Design parity: the reference defines binary IDs in ``src/ray/common/id.h`` (ObjectID
carries the owning TaskID plus an index; ActorID carries the JobID). We keep the same
*semantics* — IDs are fixed-width random/derived byte strings, cheap to hash, with a
readable hex form — without copying the reference's bit layouts.
"""

from __future__ import annotations

import os
import threading

# Width choices: 16 random bytes is collision-safe at any realistic scale and keeps
# wire messages small. (The reference uses 28-byte ObjectIDs; we don't need the
# embedded lineage bits because lineage is tracked by the owner's TaskManager table.)
_ID_NBYTES = 16

# Entropy pool: one getrandom(2) syscall per 4096 IDs instead of one per ID.
# os.urandom was the single hottest line of the task submit path (~0.7 ms per
# call on older kernels). Keyed by pid so a forked child never replays the
# parent's buffered bytes.
_POOL_BYTES = 64 * 1024
_pool_lock = threading.Lock()
_pool = b""
_pool_pos = 0
_pool_pid = -1


def _random_bytes(n: int) -> bytes:
    global _pool, _pool_pos, _pool_pid
    with _pool_lock:
        if _pool_pos + n > len(_pool) or _pool_pid != os.getpid():
            _pool = os.urandom(_POOL_BYTES)
            _pool_pos = 0
            _pool_pid = os.getpid()
        out = _pool[_pool_pos:_pool_pos + n]
        _pool_pos += n
        return out


class BaseID:
    """Immutable fixed-width binary identifier."""

    __slots__ = ("_bytes", "_hash")
    NBYTES = _ID_NBYTES

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.NBYTES:
            raise ValueError(
                f"{type(self).__name__} requires {self.NBYTES} bytes, "
                f"got {binary!r}"
            )
        self._bytes = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.NBYTES))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.NBYTES)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.NBYTES

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    NBYTES = 4


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class ObjectID(BaseID):
    """Object ids are derived from the creating task id + return index so that an
    object can be re-derived deterministically during lineage reconstruction."""

    _put_counter = 0
    _put_lock = threading.Lock()

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        import hashlib

        h = hashlib.blake2b(
            task_id.binary() + index.to_bytes(4, "little"), digest_size=cls.NBYTES
        )
        return cls(h.digest())

    @classmethod
    def for_put(cls, worker_id: WorkerID) -> "ObjectID":
        import hashlib

        with cls._put_lock:
            cls._put_counter += 1
            n = cls._put_counter
        h = hashlib.blake2b(
            b"put:" + worker_id.binary() + n.to_bytes(8, "little"),
            digest_size=cls.NBYTES,
        )
        return cls(h.digest())

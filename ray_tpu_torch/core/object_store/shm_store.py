"""Plasma-equivalent node object store over /dev/shm tmpfs files.

Parity: src/ray/object_manager/plasma/ — an immutable shared-memory object
store per node, zero-copy reads, create→seal lifecycle, eviction of
unreferenced objects, spill-to-disk hooks. Design differences from plasma,
chosen deliberately:

- one tmpfs file per object instead of one dlmalloc arena + fd passing: the
  kernel's tmpfs is the allocator; "fd passing" is just open(2) by name, which
  removes the store daemon from the read path entirely. An mmap'd object stays
  readable after eviction-unlink (POSIX semantics) so readers never race the
  evictor.
- seal = atomic rename (".b" building suffix dropped), so visibility is atomic
  without locks.

The per-node capacity ledger + LRU eviction + pinning live in the raylet
(ObjectDirectory below); workers/drivers use ShmClient for create/get.

A C++ implementation of the same layout (ops/_native) can slot in under the
same interface; the data plane here is already zero-copy so the win would be
in directory/eviction CPU, not bandwidth.

The port's copy of ray_tpu/core/object_store/shm_store.py. Its shm and spill
directories carry ``ray_tpu_torch`` names, so a port cluster and a reference
cluster on one host never share a store; the spill root lies under the
process's temporary directory. The chaos hooks are cut with the chaos
plane; the dead-node recovery edges (secondary promotion, spill adoption by
another raylet) are the reference's.
"""

from __future__ import annotations

import mmap
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store.lifecycle import (
    ObjectRecord,
    ObjectState,
    spill_crc,
)

_SHM_ROOT = "/dev/shm"


def session_dir(session: str) -> str:
    base = _SHM_ROOT if os.path.isdir(_SHM_ROOT) else tempfile.gettempdir()
    return os.path.join(base, f"ray_tpu_torch_{session}")


def default_spill_root(shm_dir: str) -> str:
    """Session-level spill root; each node spills into its own subdir (the
    shm dir is shared by all raylets of a session on a host, so a per-node
    close must not delete siblings' spilled objects)."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill",
                        os.path.basename(shm_dir))


class ShmBuffer:
    """A sealed object's mapped memory (context-managed, zero-copy)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        self._mm = mmap.mmap(self._f.fileno(), size, prot=mmap.PROT_READ)
        self.buffer = memoryview(self._mm)

    def close(self):
        # NB: numpy views over self.buffer keep the mapping alive via refcount;
        # release only when the consumer drops them.
        try:
            self.buffer.release()
            self._mm.close()
            self._f.close()
        except BufferError:
            pass  # still referenced — the mapping lives until views drop


class ShmClient:
    """Create/read objects in a node's shm directory (used by every process
    on the node; no daemon round-trip on the data path)."""

    def __init__(self, session: str):
        self.dir = session_dir(session)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, oid: ObjectID) -> str:
        return os.path.join(self.dir, oid.hex())

    def create(self, oid: ObjectID, nbytes: int) -> Tuple[mmap.mmap, "open"]:
        """Returns a writable mapping for the building object."""
        path = self._path(oid) + ".b"
        f = open(path, "w+b")
        f.truncate(max(nbytes, 1))
        mm = mmap.mmap(f.fileno(), max(nbytes, 1))
        return mm, f

    def seal(self, oid: ObjectID, mm: mmap.mmap, f) -> int:
        mm.flush()
        size = os.fstat(f.fileno()).st_size
        mm.close()
        f.close()
        os.rename(self._path(oid) + ".b", self._path(oid))
        return size

    def put_bytes(self, oid: ObjectID, data) -> int:
        """Convenience: create+write+seal in one call. data: bytes-like."""
        mm, f = self.create(oid, len(data))
        mm[: len(data)] = data
        return self.seal(oid, mm, f)

    def get(self, oid: ObjectID) -> Optional[ShmBuffer]:
        try:
            return ShmBuffer(self._path(oid))
        except FileNotFoundError:
            return None

    def contains(self, oid: ObjectID) -> bool:
        return os.path.exists(self._path(oid))

    def size_of(self, oid: ObjectID) -> Optional[int]:
        try:
            return os.path.getsize(self._path(oid))
        except FileNotFoundError:
            return None

    def delete(self, oid: ObjectID) -> None:
        try:
            os.unlink(self._path(oid))
        except FileNotFoundError:
            pass

    def destroy(self):
        shutil.rmtree(self.dir, ignore_errors=True)
        # Also reclaim this session's default spill root (all nodes' subdirs)
        # — spilled objects must not outlive the session (advisor finding r2).
        shutil.rmtree(default_spill_root(self.dir), ignore_errors=True)


class ObjectDirectory:
    """Raylet-side ledger: which objects exist locally (and in which
    lifecycle state), capacity accounting, LRU eviction, proactive spill,
    restore-on-get with RESTORING dedup.

    Every entry is a :class:`~ray_tpu_torch.core.object_store.lifecycle.ObjectRecord`
    and every state change goes through its ``transition`` — eviction,
    spill, restore, promotion and free are all edges of the same explicit
    machine, so an impossible sequence raises ``IllegalTransitionError``
    instead of corrupting the ledger.

    Eviction order under pressure (``_evict_locked``): unpinned SECONDARY
    copies first (the primary lives elsewhere — dropping loses nothing),
    then PRIMARY copies cold-first with spill-backed ones preferred (the
    shm copy is dropped only once the bytes are safely on disk), then a
    typed refusal. A pinned primary may lose its shm copy to disk but its
    record is never destroyed by pressure.

    Parity: plasma's ObjectLifecycleManager + EvictionPolicy
    (object_lifecycle_manager.h, eviction_policy.h).
    """

    def __init__(self, client: ShmClient, capacity_bytes: int,
                 spill_dir: Optional[str] = None, node_id: str = "node"):
        self.client = client
        self.capacity = capacity_bytes
        self.used = 0  # in-memory (PRIMARY + SECONDARY) bytes only
        # bytes promised to in-flight ingests (pulls mid-transfer): they
        # count against free space so concurrent ensure/reserve calls
        # can't all validate against the same headroom and overcommit
        self.reserved = 0
        self.entries: Dict[ObjectID, ObjectRecord] = {}
        # Spilling is the eviction safety net (eviction never destroys the
        # only copy), so a spill dir always exists — default: a per-node
        # subdir under the session spill root.
        self.spill_dir = spill_dir or os.path.join(
            default_spill_root(client.dir), node_id
        )
        self._lock = _san.make_lock("core.shm_store")
        self.evictions = 0
        self.spills = 0    # spill files written
        self.restores = 0  # spilled objects brought back into shm
        # raylet hooks, both called AFTER the lock drops:
        # - evict_listener(oids): the last local copy (shm AND spill) of
        #   these objects is gone — deregister from the GCS location table
        #   so stale holders never serve a vanished object
        # - spill_listener([(oid, path, nbytes, crc)]): a spill file now
        #   backs these objects — register the metadata at the GCS so a
        #   surviving node can adopt the file if this raylet dies
        self.evict_listener = None
        self.spill_listener = None
        self._pending_evicted: list = []
        self._pending_spilled: list = []
        # RESTORING dedup: concurrent restore() calls for the same object
        # wait on the first reader's event instead of re-reading the file
        self._restore_waits: Dict[ObjectID, threading.Event] = {}

    @property
    def spilled(self) -> Dict[ObjectID, str]:
        """Spill-file view (oid -> path) over the lifecycle records."""
        return {o: r.spill_path for o, r in list(self.entries.items())
                if r.spill_path}

    def add(self, oid: ObjectID, nbytes: int, role: str = "primary"):
        """Account a sealed shm object. ``role`` is ``"primary"`` for
        owner-put / promoted copies, ``"secondary"`` for pulled caches."""
        state = (ObjectState.SECONDARY if role == "secondary"
                 else ObjectState.PRIMARY)
        with self._lock:
            rec = self.entries.get(oid)
            now = time.monotonic()
            if rec is not None:
                if not rec.in_memory:
                    # bytes came back over the wire for a spilled record
                    # (e.g. a pull raced a spill): walk the restore edges
                    if rec.state is ObjectState.SPILLED:
                        rec.transition(ObjectState.RESTORING, oid.hex())
                    rec.transition(ObjectState.PRIMARY, oid.hex())
                    rec.last_access = now
                    self.used += rec.nbytes
                return
            self.entries[oid] = ObjectRecord(nbytes, now, now, state=state)
            self.used += nbytes
            if self.used > self.capacity:
                self._evict_locked(self.used - self.capacity)
        self._notify_listeners()

    def touch(self, oid: ObjectID):
        e = self.entries.get(oid)
        if e:
            e.last_access = time.monotonic()

    def pin(self, oid: ObjectID, ttl_s: float) -> bool:
        """Set/renew the owner's pin lease on an object (any live state).
        Leases expire on their own so a crashed owner can't wedge eviction."""
        with self._lock:
            e = self.entries.get(oid)
            if e is None:
                return False
            e.pin(ttl_s)
            return True

    def unpin(self, oid: ObjectID):
        with self._lock:
            e = self.entries.get(oid)
            if e:
                e.unpin()

    def ensure_capacity(self, nbytes: int) -> bool:
        with self._lock:
            free = self.capacity - self.used - self.reserved
            if free >= nbytes:
                return True
            ok = self._evict_locked(nbytes - free)
        self._notify_listeners()
        return ok

    def reserve(self, nbytes: int) -> bool:
        """ensure_capacity that also RESERVES the bytes: the promise holds
        against every later ensure/reserve until release_reservation. The
        ingest path reserves before bytes land and releases right before
        its `add` accounts them for real."""
        nbytes = int(nbytes)
        with self._lock:
            free = self.capacity - self.used - self.reserved
            ok = free >= nbytes or self._evict_locked(nbytes - free)
            if ok:
                self.reserved += nbytes
        self._notify_listeners()
        return ok

    def release_reservation(self, nbytes: int) -> None:
        with self._lock:
            self.reserved = max(0, self.reserved - int(nbytes))

    def _notify_listeners(self) -> None:
        """Deliver eviction/spill notifications queued under the lock."""
        if self._pending_evicted:
            evicted, self._pending_evicted = self._pending_evicted, []
            cb = self.evict_listener
            if cb is not None:
                try:
                    cb(evicted)
                except Exception:  # noqa: BLE001 - bookkeeping never breaks eviction
                    pass
        if self._pending_spilled:
            spilled, self._pending_spilled = self._pending_spilled, []
            cb = self.spill_listener
            if cb is not None:
                try:
                    cb(spilled)
                except Exception:  # noqa: BLE001
                    pass

    def delete(self, oid: ObjectID):
        """Owner free / force delete: FREED is terminal — shm copy, spill
        file and record all go, and the eviction listener fires so every
        GCS-advertised location (including a spill-backed one) is
        deregistered with the backing bytes."""
        existed = False
        with self._lock:
            rec = self.entries.pop(oid, None)
            if rec:
                existed = True
                if rec.in_memory:
                    self.used -= rec.nbytes
                rec.transition(ObjectState.FREED, oid.hex())
            self.client.delete(oid)
            if rec and rec.spill_path:
                try:
                    os.unlink(rec.spill_path)
                except OSError:
                    pass
            if existed:
                self._pending_evicted.append(oid)
            ev = self._restore_waits.pop(oid, None)
        if ev:
            ev.set()
        self._notify_listeners()

    def _evict_locked(self, need: int) -> bool:
        """Free ``need`` in-memory bytes, cheapest copies first.

        Wave 1 drops unpinned SECONDARY caches LRU-first (the authoritative
        copy lives on another node). Wave 2 spill-evicts PRIMARY copies
        cold-first, preferring ones already backed by a spill file; a
        primary's shm copy is only unlinked once its bytes are safely on
        disk, so live ObjectRefs can always restore() it — pinned or not,
        a primary is never silently destroyed. Objects that fail to spill
        are skipped; running out of victims makes this return False and
        the caller surfaces typed backpressure (ObjectStoreFullError)
        instead of dropping live data.
        """
        now = time.monotonic()
        freed = 0
        secondaries = sorted(
            (o for o, r in self.entries.items()
             if r.state is ObjectState.SECONDARY and not r.pinned(now)),
            key=lambda o: self.entries[o].last_access,
        )
        for oid in secondaries:
            if freed >= need:
                return True
            r = self.entries.pop(oid)
            r.transition(ObjectState.FREED, oid.hex())
            self.client.delete(oid)
            self.used -= r.nbytes
            freed += r.nbytes
            self.evictions += 1
            self._pending_evicted.append(oid)
        primaries = sorted(
            (o for o, r in self.entries.items()
             if r.state is ObjectState.PRIMARY),
            key=lambda o: (self.entries[o].spill_path is None,
                           self.entries[o].last_access),
        )
        for oid in primaries:
            if freed >= need:
                break
            r = self.entries[oid]
            if r.spill_path is None:
                self._spill_locked(oid)
                if r.spill_path is None:
                    continue  # couldn't persist: not safe to evict
            r.transition(ObjectState.SPILLED, oid.hex())
            self.client.delete(oid)
            self.used -= r.nbytes
            freed += r.nbytes
            self.evictions += 1
        return freed >= need

    def _spill_locked(self, oid: ObjectID) -> None:
        """Write the spill file for an in-memory object (no state change:
        the record stays PRIMARY, now disk-backed)."""
        rec = self.entries.get(oid)
        if rec is None or rec.spill_path:
            return
        buf = self.client.get(oid)
        if buf is None:
            return
        data = bytes(buf.buffer)
        buf.close()
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, oid.hex())
        try:
            with open(path, "wb") as f:
                f.write(data)
        except OSError:
            return
        rec.spill_path = path
        rec.spill_crc = spill_crc(data)
        self.spills += 1
        self._pending_spilled.append((oid, path, rec.nbytes, rec.spill_crc))

    def spill_cold(self, target_used: int) -> int:
        """Proactive spill: move cold PRIMARY copies to disk until in-memory
        use is at or below ``target_used``. Returns the number spilled.
        Runs ahead of pressure so eviction under load is a cheap unlink,
        and so a node death leaves disk copies behind to adopt."""
        n = 0
        with self._lock:
            if self.used <= target_used:
                return 0
            primaries = sorted(
                (o for o, r in self.entries.items()
                 if r.state is ObjectState.PRIMARY),
                key=lambda o: self.entries[o].last_access,
            )
            for oid in primaries:
                if self.used <= target_used:
                    break
                r = self.entries[oid]
                if r.spill_path is None:
                    self._spill_locked(oid)
                    if r.spill_path is None:
                        continue
                r.transition(ObjectState.SPILLED, oid.hex())
                self.client.delete(oid)
                self.used -= r.nbytes
                n += 1
        self._notify_listeners()
        return n

    def adopt_spill(self, oid: ObjectID, path: str, nbytes: int,
                    crc: Optional[int]) -> bool:
        """Dead-node recovery: take ownership of another raylet's spill
        file (same host, so the file survived the process). Verifies the
        checksum before advertising the copy."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        if crc is not None and spill_crc(data) != crc:
            return False
        with self._lock:
            if oid in self.entries:
                return True  # already hold a copy
            now = time.monotonic()
            rec = ObjectRecord(nbytes or len(data), now, now,
                               state=ObjectState.PRIMARY)
            rec.spill_path = path
            rec.spill_crc = crc if crc is not None else spill_crc(data)
            rec.transition(ObjectState.SPILLED, oid.hex())
            self.entries[oid] = rec
        return True

    def promote(self, oid: ObjectID) -> bool:
        """SECONDARY -> PRIMARY: this node's cache copy becomes the
        authoritative one after the previous primary holder died."""
        with self._lock:
            rec = self.entries.get(oid)
            if rec is None:
                return False
            if rec.state is ObjectState.SECONDARY:
                rec.transition(ObjectState.PRIMARY, oid.hex())
            return rec.state is not ObjectState.FREED

    def restore(self, oid: ObjectID) -> bool:
        """Bring a spilled object back into shm (RESTORING dedup: a
        concurrent restore of the same object waits for the first one).
        Returns True when an in-memory copy exists on exit."""
        while True:
            with self._lock:
                rec = self.entries.get(oid)
                if rec is None:
                    return False
                if rec.in_memory:
                    rec.last_access = time.monotonic()
                    return True
                if rec.state is ObjectState.RESTORING:
                    ev = self._restore_waits.setdefault(
                        oid, threading.Event())
                else:
                    if (rec.state is not ObjectState.SPILLED
                            or not rec.spill_path
                            or not os.path.exists(rec.spill_path)):
                        return False
                    rec.transition(ObjectState.RESTORING, oid.hex())
                    ev = None
            if ev is None:
                break
            ev.wait(timeout=60)  # then re-check the record's state

        try:
            with open(rec.spill_path, "rb") as f:
                data = f.read()
        except OSError:
            data = None
        if (data is not None and rec.spill_crc is not None
                and spill_crc(data) != rec.spill_crc):
            data = None  # torn spill file: fail typed, never wrong bytes
        ok = False
        if data is not None and self.ensure_capacity(len(data)):
            self.client.put_bytes(oid, data)
            ok = True
        with self._lock:
            cur = self.entries.get(oid)
            if cur is rec and rec.state is ObjectState.RESTORING:
                if ok:
                    rec.transition(ObjectState.PRIMARY, oid.hex())
                    rec.last_access = time.monotonic()
                    self.used += rec.nbytes
                    self.restores += 1
                else:
                    rec.transition(ObjectState.SPILLED, oid.hex())
            waiter = self._restore_waits.pop(oid, None)
        if waiter:
            waiter.set()
        self._notify_listeners()
        return ok

    def destroy(self):
        """Session teardown: remove the spill directory with the shm dir so
        spilled objects don't accumulate across sessions (advisor finding r2)."""
        shutil.rmtree(self.spill_dir, ignore_errors=True)

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            states = {s.value: 0 for s in ObjectState}
            pinned_bytes = 0
            spilled_bytes = 0
            in_memory = 0
            for r in self.entries.values():
                states[r.state.value] += 1
                if r.in_memory:
                    in_memory += 1
                if r.pinned(now):
                    pinned_bytes += r.nbytes
                if r.spill_path:
                    spilled_bytes += r.nbytes
            return {
                "num_objects": in_memory,
                "used_bytes": self.used,
                "capacity_bytes": self.capacity,
                "num_spilled": sum(1 for r in self.entries.values()
                                   if r.spill_path),
                "num_evicted": self.evictions,
                "num_spills": self.spills,
                "num_restores": self.restores,
                "states": states,
                "pinned_bytes": pinned_bytes,
                "spilled_bytes": spilled_bytes,
            }

"""Raylet-side PullManager: deduped, bounded, multi-source object pulls.

Parity: src/ray/object_manager/pull_manager.h — the raylet component that
owns every inbound object transfer. Responsibilities here:

- **dedup**: concurrent pulls of one oid share a single in-flight transfer
  (N waiters, one set of bytes on the wire);
- **admission**: total in-flight transfer bytes are bounded by
  ``pull_max_inflight_bytes``; excess pulls park in a priority queue where
  task-arg pulls (``priority="arg"``) are admitted ahead of background
  prefetches/restores (``priority="prefetch"``), and the byte budget is
  split fairly across jobs with live queued pulls — a job already at or
  over its ``bound / active_jobs`` share parks behind under-share jobs of
  the same class instead of monopolising the budget FIFO-style;
- **transport ladder**: chunked stream-plane transfer (chunk_transfer.py,
  resumable + striped) → native sendfile daemon → monolithic rpc fetch;
- **capacity**: every ingest path reserves store capacity via
  ``ObjectDirectory.ensure_capacity`` BEFORE bytes land and fails the pull
  typed (``{"ok": False, "reason": "store full"}``) when eviction can't
  make room — the caller falls back / reconstructs instead of silently
  overcommitting shm;
- **directory**: a completed pull registers this node as a secondary copy
  in the GCS object-location table, so later pullers fetch from the
  nearest/least-loaded holder and a hot object's broadcast becomes a
  distribution tree instead of an owner hot-spot.

All socket work runs on executor threads; the manager itself lives on the
raylet's event loop.

The port's copy of ray_tpu/core/object_store/pull_manager.py, with its
metrics (the bytes counter, the in-flight and queue gauges). ``stats``
keeps every counter, read through the raylet's ``scheduler_stats``: ``pulls`` counts the rung
each pull took (``chunked``, ``native``, ``rpc``) and ``bytes_in`` the
bytes landed.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import heapq
import itertools
import logging
import os
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import _config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import chunk_transfer
from ray_tpu_torch.core.object_store.chunk_transfer import transfer_timeout

logger = logging.getLogger(__name__)

# admission classes: lower admits first when inflight bytes free up
_PRIORITIES = {"arg": 0, "prefetch": 1}


class PullManager:
    def __init__(self, *, node_id: str, session: str, shm, directory,
                 get_view, get_gcs):
        self.node_id = node_id
        self.session = session
        self.shm = shm
        self.directory = directory
        self._get_view = get_view    # () -> gossiped cluster view dict
        self._get_gcs = get_gcs      # () -> GCS rpc connection (or None)
        self._inflight: Dict[bytes, asyncio.Future] = {}
        self._inflight_bytes = 0
        # per-job in-flight bytes: the admission budget is split across
        # jobs with live pulls, so one job's deep prefetch queue can't
        # starve another job's first arg pull behind a global FIFO
        self._job_inflight: Dict[str, int] = {}
        # heap: (priority_class, over_share, seq, gate, job)
        self._waitq: List[tuple] = []
        # effective admission class per in-flight oid (dedup callers with
        # a better class upgrade a parked pull's next re-park)
        self._pending_prio: Dict[bytes, int] = {}
        self._seq = itertools.count()
        self._peer_conns: Dict[str, rpc.Connection] = {}
        # oids this node holds as SECONDARY copies (registered in the GCS
        # location table; deregistered on local eviction/free)
        self._secondary: set = set()
        self.stats = {
            "pulls": 0, "dedup_hits": 0, "chunked": 0, "native": 0,
            "rpc": 0, "failed": 0, "capacity_refused": 0, "resumes": 0,
            "striped": 0, "queued": 0, "bytes_in": 0,
            # seconds of transfers (admission waits excluded), so a reader
            # of the stats can tell the pulls' rate: bytes_in / transfer_s
            "transfer_s": 0.0,
        }
        self._m_bytes = None
        self._g_inflight = None
        self._g_queue = None
        # pull-side blocking waits (receiver waits, seal retries) get
        # their OWN bounded pool: parking them on the loop's default
        # executor let a pull burst starve this raylet's outbound
        # push_chunks jobs (which peers' pulls depend on) — cluster-wide
        # stall cycles. Pushes use the raylet's separate push pool.
        self._wait_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="rt-pull-wait"
        )

    # ------------------------------------------------------------- metrics
    def _observe(self) -> None:
        if not _config.metrics_enabled:
            return
        from ray_tpu_torch.util import metrics as metrics_api

        if self._g_inflight is None:
            self._g_inflight = metrics_api.Gauge(
                "pull_inflight_bytes",
                "bytes of concurrently-executing object pulls",
            )
            self._g_queue = metrics_api.Gauge(
                "pull_queue_depth",
                "pulls parked behind the in-flight bytes bound",
            )
        self._g_inflight.set(self._inflight_bytes)
        self._g_queue.set(len(self._waitq))

    def _count_bytes(self, n: int) -> None:
        self.stats["bytes_in"] += n
        if not _config.metrics_enabled:
            return
        if self._m_bytes is None:
            from ray_tpu_torch.util import metrics as metrics_api

            self._m_bytes = metrics_api.Counter(
                "object_transfer_bytes_total",
                "object bytes pulled into this node's store",
            )
        self._m_bytes.inc(float(n))

    def close(self) -> None:
        self._wait_pool.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------------ public
    async def pull(self, oid: ObjectID, source_addr: Optional[str],
                   nbytes: Optional[int] = None, priority: str = "arg",
                   transport: Optional[str] = None,
                   job_id: Optional[str] = None) -> dict:
        """Pull ``oid`` into the local store. Returns ``{"ok": True}`` or
        ``{"ok": False, "reason": ...}`` (typed capacity refusal included).
        Concurrent callers for one oid share the first caller's transfer."""
        if self.shm.contains(oid):
            return {"ok": True, "already_local": True}
        if self.directory.restore(oid):
            return {"ok": True, "restored": True}
        key = oid.binary()
        fut = self._inflight.get(key)
        if fut is not None:
            self.stats["dedup_hits"] += 1
            # priority upgrade: a task-arg pull deduping onto a parked
            # BACKGROUND pull (prefetch) must not wait at background
            # priority — record the better class and wake the parked
            # entries so they re-park in the upgraded order
            cls = _PRIORITIES.get(priority, 1)
            if cls < self._pending_prio.get(key, 9):
                self._pending_prio[key] = cls
                self._wake_parked()
            return await asyncio.shield(fut)
        fut = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        self._pending_prio[key] = _PRIORITIES.get(priority, 1)
        try:
            result = await self._admitted(oid, source_addr, nbytes,
                                          priority, transport, job_id)
        except Exception as e:  # noqa: BLE001 - a pull must fail typed
            logger.exception("pull %s failed", oid.hex()[:16])
            result = {"ok": False, "reason": repr(e)}
        except BaseException as e:
            # cancelled mid-transfer: dedup waiters sharing this future
            # must not hang on it forever
            self._inflight.pop(key, None)
            self._pending_prio.pop(key, None)
            if not fut.done():
                fut.set_result({"ok": False, "reason": f"aborted: {e!r}"})
            raise
        self._inflight.pop(key, None)
        self._pending_prio.pop(key, None)
        if not fut.done():
            fut.set_result(result)
        return result

    def on_local_drop(self, oids) -> list:
        """Local copies vanished (eviction / explicit free): returns the
        subset that were advertised as SECONDARY copies, forgetting them
        locally. The caller (raylet._drop_secondaries) owns the GCS
        deregistration — this method is thread-safe (eviction fires under
        the directory lock on arbitrary threads), the GCS notify is not."""
        gone = [o for o in oids if o.binary() in self._secondary]
        for oid in gone:
            self._secondary.discard(oid.binary())
        return gone

    # ---------------------------------------------------------- admission
    def _fair_share(self, job: str) -> float:
        """This job's slice of the byte budget: ``bound / active_jobs``,
        where active = jobs with in-flight bytes or parked pulls."""
        bound = max(1, _config.pull_max_inflight_bytes)
        active = {j for j, b in self._job_inflight.items() if b > 0}
        for entry in self._waitq:
            if not entry[3].done():
                active.add(entry[4])
        active.add(job)
        return bound / len(active)

    def _over_share(self, job: str, need: int) -> int:
        """1 when admitting ``need`` more bytes would put this job over
        its fair share (and other jobs are in play), else 0."""
        share = self._fair_share(job)
        return int(self._job_inflight.get(job, 0) + need > share)

    async def _admitted(self, oid, source_addr, nbytes, priority, transport,
                        job_id=None):
        bound = max(1, _config.pull_max_inflight_bytes)
        need = int(nbytes or 0)
        key = oid.binary()
        job = job_id or "_"
        # ONE size-scaled deadline covers parking AND the transfer ladder:
        # the raylet must give up before the owner's rpc call (deadline +
        # 30s) does, or an abandoned pull keeps queueing/streaming while
        # the owner launches a duplicate direct fetch
        deadline = time.monotonic() + transfer_timeout(nbytes)
        while self._inflight_bytes and (
                self._inflight_bytes + need > bound
                or self._blocked_ahead(
                    self._pending_prio.get(key,
                                           _PRIORITIES.get(priority, 1)),
                    self._over_share(job, need))):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"ok": False, "reason": "pull admission timed out"}
            gate = asyncio.get_running_loop().create_future()
            heapq.heappush(
                self._waitq,
                # a dedup caller may have upgraded this pull's class while
                # it was parked, and the job's share drifts as pulls of
                # other jobs come and go — re-read both on every re-park
                (self._pending_prio.get(key, _PRIORITIES.get(priority, 1)),
                 self._over_share(job, need), next(self._seq), gate, job),
            )
            self.stats["queued"] += 1
            self._observe()
            try:
                await asyncio.wait_for(gate, timeout=remaining)
            except asyncio.TimeoutError:
                return {"ok": False, "reason": "pull admission timed out"}
        self._inflight_bytes += need
        self._job_inflight[job] = self._job_inflight.get(job, 0) + need
        self._observe()
        started = time.monotonic()
        try:
            return await self._transfer(oid, source_addr, nbytes, transport,
                                        deadline)
        finally:
            self.stats["transfer_s"] += time.monotonic() - started
            self._inflight_bytes -= need
            left = self._job_inflight.get(job, 0) - need
            if left > 0:
                self._job_inflight[job] = left
            else:
                self._job_inflight.pop(job, None)
            self._wake_parked()
            self._observe()

    def _blocked_ahead(self, cls: int, over: int = 0) -> bool:
        """Queue barrier: a new pull may not slip past a PARKED pull of an
        equal-or-better (class, fairness) rank — without this, steady
        small-pull traffic keeps the budget partially full forever and any
        pull larger than the free headroom starves to its deadline. The
        fairness bit makes the barrier per-job: an under-share job's first
        pull is NOT blocked by another job's parked over-share backlog."""
        while self._waitq and self._waitq[0][3].done():
            heapq.heappop(self._waitq)  # prune timed-out/cancelled gates
        return bool(self._waitq) and \
            (self._waitq[0][0], self._waitq[0][1]) <= (cls, over)

    def _wake_parked(self) -> None:
        """Wake EVERY parked pull in (class, fairness) order: each
        re-checks the budget and re-parks if it still doesn't fit. Waking
        only one collapsed concurrency to one-pull-per-completion once a
        queue formed, even with most of the byte budget free."""
        while self._waitq:
            entry = heapq.heappop(self._waitq)
            gate = entry[3]
            if not gate.done():
                gate.set_result(None)

    # ----------------------------------------------------------- transfer
    async def _transfer(self, oid, source_addr, nbytes, transport, deadline):
        self.stats["pulls"] += 1
        sources = await self._sources(oid, source_addr, nbytes)
        if not sources:
            self.stats["failed"] += 1
            return {"ok": False, "reason": "no reachable holder"}
        if transport in (None, "chunked") and _config.pull_chunked_enabled \
                and nbytes:
            n = await self._chunked_pull(oid, int(nbytes), sources, deadline)
            if n is not None:
                if n < 0:
                    self.stats["capacity_refused"] += 1
                    return {"ok": False, "reason": "store full"}
                return await self._finish(oid, n, "chunked")
            if transport == "chunked":
                self.stats["failed"] += 1
                return {"ok": False, "reason": "chunked transfer failed"}
        if transport in (None, "native") and time.monotonic() < deadline:
            n = await self._native_pull(oid, sources, nbytes, deadline)
            if n is not None:
                if n < 0:
                    self.stats["capacity_refused"] += 1
                    return {"ok": False, "reason": "store full"}
                return await self._finish(oid, n, "native")
        if transport in (None, "rpc") and time.monotonic() < deadline:
            return await self._rpc_pull(oid, sources, nbytes, deadline)
        self.stats["failed"] += 1
        return {"ok": False, "reason": f"transport {transport!r} failed"}

    async def _finish(self, oid, n: int, kind: str) -> dict:
        self.stats[kind] += 1
        self._count_bytes(n)
        # a pulled copy is a SECONDARY in the lifecycle machine: cheap to
        # drop under pressure (the authoritative copy lives elsewhere),
        # promotable to PRIMARY if the original holder's node dies
        self.directory.add(oid, n, role="secondary")
        # register only copies big enough that _sources will ever look
        # them up — sub-chunk objects would grow the GCS table and pay a
        # notify per pull for a directory nobody queries
        if n >= _config.pull_chunk_bytes:
            await self._register_secondary(oid, n)
        return {"ok": True, "nbytes": n, "transport": kind}

    async def _sources(self, oid, source_addr, nbytes) -> List[dict]:
        """Holder list: GCS-registered copies (already rotated server-side
        for distribution-tree spreading) plus the caller's primary address.
        Same-session holders are excluded — their shm dir is ours."""
        out: List[dict] = []
        gcs = self._get_gcs()
        if gcs is not None and not gcs.closed and nbytes \
                and int(nbytes) >= _config.pull_chunk_bytes:
            try:
                holders = await gcs.call(
                    "object_locations", oid_hex=oid.hex(), timeout=10
                )
            except (rpc.RpcError, rpc.ConnectionLost):
                holders = None
            for h in holders or []:
                if h.get("session") != self.session and h.get("address"):
                    out.append(h)
        if source_addr and all(h["address"] != source_addr for h in out):
            primary = {"address": source_addr, "node_id": None,
                       "transfer_port": None, "session": None}
            for v in self._get_view().values():
                if v.get("address") == source_addr:
                    if not v.get("alive"):
                        primary = None
                    else:
                        primary["transfer_port"] = v.get("transfer_port")
                        primary["session"] = v.get("session")
                    break
            if primary is not None and primary.get("session") != self.session:
                out.append(primary)
        return out

    async def _register_secondary(self, oid, nbytes: int) -> None:
        self._secondary.add(oid.binary())
        gcs = self._get_gcs()
        if gcs is None or gcs.closed:
            return
        try:
            await gcs.notify(
                "object_location_add", oid_hex=oid.hex(),
                node_id=self.node_id, nbytes=nbytes,
            )
        except (rpc.RpcError, rpc.ConnectionLost):
            pass  # soft state: later pullers just miss this holder

    # ---------------------------------------------------- chunked (stream)
    async def _chunked_pull(self, oid, nbytes: int, sources: List[dict],
                            deadline: float) -> Optional[int]:
        """Chunked stream-plane pull; returns byte count, -1 for a typed
        capacity refusal, or None (callers fall down the transport
        ladder). RESERVES store capacity before bytes land (concurrent
        pulls can't all validate against the same headroom), lands chunks
        straight into the building shm mmap, stripes disjoint ranges
        across holders, and resumes missing chunks after a severed stream
        — against another holder when one exists — until ``deadline``."""
        if not self.directory.reserve(nbytes):
            return -1
        loop = asyncio.get_running_loop()
        mm = f = None
        sealed = False
        try:
            from ray_tpu_torch.core.transport import stream as stream_mod

            chunk = max(1 << 16, _config.pull_chunk_bytes)
            listener = stream_mod.get_listener()
            missing = set(range(chunk_transfer.chunk_count(nbytes, chunk)))
            order = list(sources)
            mm, f = self.shm.create(oid, nbytes)
            for round_no in range(3):
                remaining = deadline - time.monotonic()
                if not missing or not order or remaining <= 0:
                    break
                if round_no > 0:
                    self.stats["resumes"] += 1
                stripe = 1
                if (len(order) > 1
                        and nbytes >= _config.pull_stripe_min_bytes):
                    stripe = min(len(order), max(1, _config.pull_max_stripe))
                    if round_no == 0:
                        self.stats["striped"] += 1
                plan = _split(sorted(missing), stripe)
                receivers, dead = [], []
                for src, idxs in zip(order, plan):
                    cid = f"pull-{oid.hex()[:12]}-{uuid.uuid4().hex[:6]}"
                    token = uuid.uuid4().hex
                    recv = chunk_transfer.ChunkReceiver(
                        cid, token, mm, nbytes, chunk, set(idxs),
                        spool_dir=self.shm.dir,
                    )
                    host, port = listener.register(recv)
                    ok = await self._request_push(
                        src, oid, sorted(idxs), nbytes, chunk, host, port,
                        cid, token,
                    )
                    if not ok:
                        listener.deregister(cid)
                        recv.sever("push refused")
                        dead.append(src)
                        continue
                    receivers.append((cid, recv, len(idxs) * chunk))
                if not receivers:
                    order = [s for s in order if s not in dead]
                    continue
                await asyncio.gather(*[
                    loop.run_in_executor(
                        self._wait_pool, recv.wait,
                        min(transfer_timeout(span), remaining),
                    )
                    for _cid, recv, span in receivers
                ])
                for cid, recv, _span in receivers:
                    listener.deregister(cid)
                    recv.sever("pull round settled")
                    missing -= recv.received
                # demote holders that failed their whole range: a fresh
                # round prefers the others (resume against another source)
                alive = [s for s in order if s not in dead]
                order = alive[1:] + alive[:1] if len(alive) > 1 else alive
            if missing:
                return None
            sealed = await loop.run_in_executor(
                self._wait_pool, self._seal, oid, mm, f
            )
            return nbytes if sealed else None
        finally:
            # always runs for a successful reserve(): a leak here would
            # permanently shrink the store's usable headroom
            self.directory.release_reservation(nbytes)
            if not sealed and mm is not None:  # failed: drop building file
                await loop.run_in_executor(
                    self._wait_pool, self._discard_building, oid, mm, f
                )

    def _seal(self, oid, mm, f) -> bool:
        """Executor-side seal: a severed receiver's landing thread may
        still hold a memoryview export over the mmap for a moment (its
        socket just closed) — mmap.close() raises BufferError until the
        view drops, so retry briefly instead of failing a fully-landed
        pull."""
        for _ in range(100):
            try:
                self.shm.seal(oid, mm, f)
                return True
            except BufferError:
                time.sleep(0.02)
            except OSError:
                return False
        return False

    def _discard_building(self, oid, mm, f) -> None:
        """Drop a failed pull's building file. Unlink FIRST (needs no
        mapping teardown — the tmpfs pages free when the last mapping
        drops), then close the handles tolerating straggler exports."""
        try:
            os.unlink(self.shm._path(oid) + ".b")
        except OSError:
            pass
        for _ in range(100):
            try:
                mm.close()
                break
            except BufferError:
                time.sleep(0.02)
            except (OSError, ValueError):
                break
        try:
            f.close()
        except OSError:
            pass

    async def _request_push(self, src, oid, indices, nbytes, chunk,
                            host, port, cid, token) -> bool:
        conn = await self._conn(src["address"])
        if conn is None:
            return False
        try:
            reply = await conn.call(
                "push_chunks", oid_hex=oid.hex(), indices=indices,
                nbytes=nbytes, chunk_bytes=chunk, host=host, port=port,
                channel_id=cid, token=token, timeout=30,
            )
        except (rpc.RpcError, rpc.ConnectionLost):
            return False
        return bool(reply and reply.get("ok"))

    # ------------------------------------------------------ native daemon
    async def _native_pull(self, oid, sources, nbytes,
                           deadline: float) -> Optional[int]:
        """Stream via a holder's sendfile daemon; returns byte count, -1
        for a typed capacity refusal, or None (unavailable → rpc path).
        Bounded by the pull's REMAINING deadline, never a fresh budget —
        the owner's rpc gives up at deadline+30s and a rung outliving it
        would stream bytes nobody is waiting on."""
        src = next((s for s in sources if s.get("transfer_port")), None)
        if src is None:
            return None
        from ray_tpu_torch.core.object_store import native as native_mod

        host = src["address"].rsplit(":", 1)[0]
        port = src["transfer_port"]
        token = rpc.get_auth_token() or "none"
        dest = self.shm._path(oid)
        # reserve LAST, immediately before the guarded transfer: anything
        # raising between reserve and the releasing finally leaks headroom
        if nbytes and not self.directory.reserve(int(nbytes)):
            return -1
        try:
            n = await asyncio.get_event_loop().run_in_executor(
                None, native_mod.fetch_to_file, host, port, token, oid.hex(),
                dest, max(1.0, deadline - time.monotonic()),
            )
        finally:
            if nbytes:
                self.directory.release_reservation(int(nbytes))
        if n is None:
            return None
        if not nbytes and not self.directory.ensure_capacity(n):
            # size was unknown up front: reconcile now, and REFUSE typed
            # (dropping the landed bytes) rather than overcommit the store
            self.shm.delete(oid)
            return -1
        return n

    # -------------------------------------------------------- rpc fallback
    async def _rpc_pull(self, oid, sources, nbytes, deadline: float) -> dict:
        last = "unreachable"
        for src in sources:
            peer = await self._conn(src["address"])
            if peer is None:
                continue
            try:
                data = await peer.call(
                    "fetch_object", oid_hex=oid.hex(),
                    timeout=max(1.0, deadline - time.monotonic()),
                )
            except (rpc.RpcError, rpc.ConnectionLost) as e:
                last = repr(e)
                continue
            if data is None:
                last = "not on holder"
                continue
            data = rpc.unwrap_oob(data)  # zero-copy view over the frame
            n = data.nbytes if isinstance(data, memoryview) else len(data)
            if not self.directory.reserve(n):
                self.stats["capacity_refused"] += 1
                return {"ok": False, "reason": "store full"}
            try:
                # full-object memcpy + tmpfs write: off the event loop,
                # like every other blocking transfer in this file
                await asyncio.get_event_loop().run_in_executor(
                    self._wait_pool, self.shm.put_bytes, oid, data,
                )
            finally:
                self.directory.release_reservation(n)
            return await self._finish(oid, n, "rpc")
        self.stats["failed"] += 1
        return {"ok": False, "reason": last}

    async def _conn(self, addr: str) -> Optional[rpc.Connection]:
        conn = self._peer_conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        try:
            conn = await rpc.connect(addr, retries=3)
        except rpc.ConnectionLost:
            return None
        self._peer_conns[addr] = conn
        return conn


def _split(indices: List[int], ways: int) -> List[List[int]]:
    """Contiguous near-equal slices of the missing chunk list, one per
    striping source (disjoint by construction)."""
    ways = max(1, min(ways, len(indices)))
    per = (len(indices) + ways - 1) // ways
    return [indices[i * per:(i + 1) * per] for i in range(ways)]

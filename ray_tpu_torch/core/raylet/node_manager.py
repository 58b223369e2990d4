"""Raylet: per-node daemon — local scheduler, worker pool, object plane.

Parity: src/ray/raylet/node_manager.h:117 (NodeManager implements the node RPC
service and the resource reporter), local_task_manager.cc (dispatch + spillback),
plasma store runner (here: shm_store.ObjectDirectory), agent manager.

Leases: owners request a worker lease for a resource demand (§3.2 of SURVEY);
the raylet queues the request, grants (worker address) when resources + a
worker are available, or replies with a spillback target from the gossiped
cluster view.

The port's copy of ray_tpu/core/raylet/node_manager.py: leases, the worker
pool, placement-group bundles, blocked-worker release, the shm object
directory with spill and restore, the log monitor, and the cross-node parts:
the gossiped cluster view, spillback, arg-locality hints and prefetch, the
PullManager and the native TransferServer (each started and stopped with the
raylet), chunk pushes, the dead-node promotion and spill adoption, and the
GCS location records on seal, spill, eviction and free. A demand no node of
the cluster can fit fails typed after the lease timeout ("no node can fit
demand", the reference's words); a GPU demand is never run on the CPU. The
observability planes are the reference's: the LEASED task event and the
raylet's task-event flush, the recovery of a SIGKILLed worker's task-event
WAL, the lease-grant histogram, the locality counters and the metrics flush
(the same counters stay readable through ``scheduler_stats`` and
``object_store_stats``). Cut with their planes: the shipping of WAL tails
to the GCS and the orphaned-WAL sweep (whole-node-loss forensics), chaos,
the compiled graphs' endpoint cleanup, and ``drain_node`` (autoscaling).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import signal
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch import tracing
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import _config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store.pull_manager import PullManager
from ray_tpu_torch.core.object_store.shm_store import ObjectDirectory, ShmClient
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.core.scheduling_policy import (
    NodeView,
    hybrid_policy,
    locality_policy,
    locality_score,
)
from ray_tpu_torch.core.raylet.worker_pool import (
    ACTOR,
    DEAD,
    IDLE,
    LEASED,
    WorkerHandle,
    WorkerPool,
    session_log_dir,
)

logger = logging.getLogger(__name__)

# the least gap between two resource reports that a change triggered
_REPORT_COALESCE_S = 0.05


@dataclass
class LeaseRequest:
    lease_id: str
    demand: ResourceSet
    future: asyncio.Future
    queued_at: float = field(default_factory=time.monotonic)
    allow_spillback: bool = True
    # set for placement-group tasks: consume the bundle's reservation instead
    # of node-level availability (the bundle already holds the resources)
    pg_id: Optional[bytes] = None
    bundle_index: int = -1
    owner_conn: object = None
    req_id: Optional[str] = None   # owner-side id for cancellation
    # tracing: identity of the task that triggered the request, so the
    # grant records a LEASED event (cached-lease reuse skips the raylet)
    task_id: Optional[str] = None
    task_name: str = ""
    trace_id: Optional[str] = None
    # locality: owner-recorded (oid_hex, nbytes, node_id) locations of the
    # task's by-reference args — dispatch prefers a feasible node already
    # holding the largest args, and queued leases prefetch remote args
    arg_hints: Optional[list] = None
    # one locality-driven spillback attempt per lease (no ping-pong)
    locality_checked: bool = False
    # one arg-prefetch kick per lease, AFTER it survives the locality
    # check (prefetching before it would pull bytes for a lease about to
    # spill to the node already holding them)
    prefetched: bool = False


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        session: str,
        node_id: Optional[str] = None,
        resources: Optional[Dict[str, float]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        object_store_memory_mb: Optional[int] = None,
        spill_dir: Optional[str] = None,
        worker_env: Optional[dict] = None,
    ):
        self.node_id = node_id or uuid.uuid4().hex[:16]
        self.session = session
        self.gcs_address = gcs_address
        self.server = rpc.RpcServer(self, host=host, port=port)
        self.total = ResourceSet(resources or {})
        self._report_wake = asyncio.Event()
        self.available = ResourceSet(resources or {})
        self.shm = ShmClient(session)
        cap_mb = object_store_memory_mb or _config.object_store_memory_mb
        self.directory = ObjectDirectory(
            self.shm, cap_mb * 1024 * 1024,
            spill_dir=spill_dir or _config.object_spilling_dir or None,
            node_id=self.node_id,
        )
        self.worker_env = worker_env or {}
        self.pool: Optional[WorkerPool] = None
        self.gcs: Optional[rpc.Connection] = None
        self.pending_leases: List[LeaseRequest] = []
        self.active_leases: Dict[str, Tuple[ResourceSet, WorkerHandle, tuple]] = {}
        self.cluster_view: Dict[str, dict] = {}
        self.bundles: Dict[Tuple[bytes, int], ResourceSet] = {}
        self.bundle_free: Dict[Tuple[bytes, int], ResourceSet] = {}
        self._bg: List[asyncio.Task] = []
        # strong refs to one-shot tasks (dispatch kicks, actor adoption
        # announcements) until done — the loop holds tasks weakly and a
        # GC'd dispatch kick leaves granted-but-unsent leases (raylint
        # RT003)
        self._held_tasks: set = set()
        self._actor_specs: Dict[bytes, bytes] = {}
        self.transfer = None               # native data-plane daemon
        self.transfer_port: Optional[int] = None
        # object plane: every inbound transfer funnels through the pull
        # manager (dedup, inflight-bytes bound, chunked/native/rpc ladder)
        self.pulls = PullManager(
            node_id=self.node_id, session=session, shm=self.shm,
            directory=self.directory,
            get_view=lambda: self.cluster_view,
            get_gcs=lambda: self.gcs,
        )
        # eviction/free of a copy deregisters it from the GCS location
        # table; a spill-file write registers its metadata there so a
        # surviving node can adopt it after this raylet dies (both
        # listeners fire on arbitrary threads, so the notifies are
        # trampolined onto the raylet loop)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.directory.evict_listener = self._on_objects_evicted
        self.directory.spill_listener = self._on_objects_spilled
        self._pushes_served = 0            # chunk ranges served to pullers
        # outbound chunk pushes run on their own bounded pool, isolated
        # from the pull manager's receiver waits — a local pull burst must
        # never starve the pushes remote pullers are blocked on
        self._push_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="rt-push"
        )
        self._m_locality = None            # (hits counter, misses counter)
        # dispatch decision counters (scheduler_stats["dispatch"], also
        # exported as raylet_dispatch_* gauges):
        # spillbacks, locality hits/misses and spillbacks, prefetch kicks
        self._disp: Dict[str, int] = {
            "grants": 0, "skipped_no_worker": 0,
            "skipped_no_resources": 0, "done": 0, "seen": 0,
            "spillbacks": 0,
        }
        # actor_id → (release token from _acquire_for-style accounting, demand)
        self._actor_resources: Dict[bytes, Tuple[object, ResourceSet]] = {}
        # conn → lease_ids it holds (reclaimed on disconnect; lease caching
        # on the owner side means leases outlive individual tasks)
        self._lease_owners: Dict[object, set] = {}
        # leases whose resources are RELEASED because their worker reported
        # itself blocked in ray.get (NotifyDirectCallTaskBlocked parity):
        # blocked workers must not hold CPU their upstream tasks need, or
        # task-waits-for-task pipelines deadlock at the worker cap
        self._blocked_leases: set = set()
        # lease_id → (pg_id, bundle_index) for PG leases: blocked-worker
        # re-acquire must draw from the SAME bundle, not node availability
        self._lease_pg: Dict[str, Tuple[Optional[bytes], int]] = {}
        # the node's cards by CUDA_VISIBLE_DEVICES name, and the share of
        # each still free: a GPU lease or actor holds named cards, which its
        # worker makes its own CUDA_VISIBLE_DEVICES
        n_cards = int(self.total.get("GPU"))
        visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "")
                   .split(",") if c.strip()]
        names = visible if len(visible) >= n_cards else [
            str(i) for i in range(n_cards)]
        self._card_free: Dict[str, float] = {c: 1.0 for c in names[:n_cards]}
        # lease_id / actor_id → [(card, share)] it holds
        self._lease_cards: Dict[str, List[Tuple[str, float]]] = {}
        self._actor_cards: Dict[bytes, List[Tuple[str, float]]] = {}
        self._m_lease_grant = None  # queued->granted latency histogram

    def _observe_lease_grant(self, lease: LeaseRequest) -> None:
        if not _config.metrics_enabled:
            return
        if self._m_lease_grant is None:
            from ray_tpu_torch.util import metrics as metrics_api

            self._m_lease_grant = metrics_api.Histogram(
                "raylet_lease_grant_ms",
                "lease request queued -> worker granted",
                boundaries=metrics_api.LATENCY_MS_BOUNDS,
            )
        self._m_lease_grant.observe(
            (time.monotonic() - lease.queued_at) * 1000
        )

    def _hold(self, task: "asyncio.Task") -> "asyncio.Task":
        """Keep a one-shot task alive until done (RT003 pattern)."""
        self._held_tasks.add(task)
        task.add_done_callback(self._held_tasks.discard)
        return task

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        self._loop = asyncio.get_running_loop()
        await self.server.start()
        tracing.get_buffer().set_identity(self.node_id, self.server.address)
        self.pool = WorkerPool(
            self.server.address, self.gcs_address, self.session, self.node_id,
            env=dict(self.worker_env),
        )
        self.pool.on_worker_death = self._on_worker_death
        # native data plane: sendfile daemon serving this node's shm dir
        # (None → pulls from this node take the chunked or rpc rung). start()
        # may compile the daemon (g++, seconds cold) — off the event loop.
        from ray_tpu_torch.core.object_store import native as native_mod
        from ray_tpu_torch.core.object_store.shm_store import session_dir

        self.transfer = native_mod.TransferServer(
            session_dir(self.session), rpc.get_auth_token() or "none",
            bind_host=self.server.host,
        )
        self.transfer_port = await asyncio.get_event_loop().run_in_executor(
            None, self.transfer.start
        )
        if self.transfer_port is None:
            logger.warning("raylet %s: no native transfer daemon; its node "
                           "registers transfer_port None", self.node_id)
        self.gcs = await rpc.connect(
            self.gcs_address, handler=self, name=f"raylet-{self.node_id}->gcs"
        )
        await self._register_node()
        self._bg.append(asyncio.create_task(self._report_loop()))
        self._bg.append(asyncio.create_task(self._poll_loop()))
        # observability plane: tail this node's worker logs to the driver
        # (log_monitor.py ↔ reference log_monitor.py) and flush core metrics
        # and task events
        from ray_tpu_torch.core.raylet.log_monitor import LogMonitor

        self.log_monitor = LogMonitor(session_log_dir(self.session), self.node_id)
        self._bg.append(
            asyncio.create_task(self.log_monitor.run(self._publish_logs))
        )
        self._bg.append(asyncio.create_task(self._metrics_flush_loop()))
        self._bg.append(asyncio.create_task(self._task_events_flush_loop()))
        self._bg.append(asyncio.create_task(self._spill_loop()))
        self._bg.append(asyncio.create_task(self._spool_sweep_loop()))
        if _config.enable_worker_prestart:
            n = min(2, int(self.total.get("CPU")) or 1)
            for _ in range(n):
                self.pool.start_worker()
        logger.info(
            "raylet %s on %s resources=%s",
            self.node_id, self.server.address, self.total.to_dict(),
        )
        return self.server.address

    async def _register_node(self):
        # a node's death reaches this raylet's view at once, not at its
        # next refresh: a lease spilled to a dead raylet would fail
        self.gcs.on_push("node", self._on_node_event)
        await self.gcs.call("subscribe", channels=["node"])
        await self.gcs.call(
            "register_node",
            node_id=self.node_id,
            address=self.server.address,
            session=self.session,
            resources=self.total.to_dict(),
            labels=self._labels(),
            transfer_port=self.transfer_port,
        )

    def _on_node_event(self, payload) -> None:
        if payload.get("event") == "dead":
            view = self.cluster_view.get(payload.get("node_id"))
            if view is not None:
                view["alive"] = False

    def _labels(self) -> Dict[str, str]:
        """Node labels (the reference's names a node's TPU slice): the kind
        of this node's cards, from its ``GPU-<kind>`` resource."""
        for key in self.total.to_dict():
            if key.startswith("GPU-"):
                return {"gpu-kind": key[len("GPU-"):]}
        return {}

    async def close(self):
        for t in self._bg:
            t.cancel()
        self._push_pool.shutdown(wait=False, cancel_futures=True)
        self.pulls.close()
        if self.transfer is not None:
            self.transfer.stop()
        if self.pool:
            self.pool.shutdown()
        if self.gcs:
            await self.gcs.close()
        await self.server.close()
        # reclaim this raylet's spill directory (covers configured spill dirs;
        # ShmClient.destroy only knows the default location)
        self.directory.destroy()

    @property
    def available(self) -> ResourceSet:
        return self._available

    @available.setter
    def available(self, value: ResourceSet) -> None:
        self._available = value
        self._report_wake.set()

    async def _report_loop(self):
        """Report this node's free resources and read the cluster's view
        once a health period, and soon after a change here or an offload
        that found no peer free: with the period alone a peer's offload
        read a view up to two periods old (the reference's loop)."""
        period = _config.health_check_period_ms / 1000
        while True:
            self._report_wake.clear()
            try:
                if self.gcs is None or self.gcs.closed:
                    await self._reconnect_gcs()
                await self.gcs.call(
                    "resource_report",
                    node_id=self.node_id,
                    available=self.available.to_dict(),
                )
                self.cluster_view = await self.gcs.call("get_resource_view")
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
            try:
                await asyncio.wait_for(self._report_wake.wait(), period)
            except asyncio.TimeoutError:
                continue
            await asyncio.sleep(_REPORT_COALESCE_S)  # a burst, one report

    async def _reconnect_gcs(self):
        """GCS died (restart under fault tolerance): re-dial and re-register
        this node so a store-restored GCS regains the cluster."""
        self.gcs = await rpc.connect(
            self.gcs_address, handler=self,
            name=f"raylet-{self.node_id}->gcs", retries=3, retry_delay=0.3,
        )
        await self._register_node()
        logger.warning("re-registered with GCS at %s", self.gcs_address)

    async def _poll_loop(self):
        self._poll_ticks = 0
        while True:
            try:
                await self.pool.poll_deaths()
                await self._dispatch()
                self._poll_ticks += 1
            except Exception:  # noqa: BLE001 - the loop must survive anything
                logger.exception("raylet poll loop error")
            await asyncio.sleep(0.05)

    async def _publish_logs(self, batch: dict):
        if self.gcs is not None and not self.gcs.closed:
            try:
                await self.gcs.notify("publish_logs", batch=batch)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass

    async def _spill_loop(self):
        """Proactive spill: once in-memory use crosses
        ``object_spill_threshold_frac`` of capacity, move cold PRIMARY
        copies to the spill dir (LRU by last access) until back under the
        threshold. Pressure-time eviction then degrades to a cheap unlink
        of already-disk-backed copies, and a SIGKILLed raylet leaves spill
        files + GCS-registered metadata behind for a survivor to adopt.
        The disk writes run on an executor thread, never the raylet loop."""
        period = max(0.05, _config.object_spill_interval_s)
        frac = min(1.0, max(0.0, _config.object_spill_threshold_frac))
        while True:
            try:
                target = int(self.directory.capacity * frac)
                if self.directory.used > target:
                    await asyncio.get_event_loop().run_in_executor(
                        None, self.directory.spill_cold, target
                    )
            except Exception:  # noqa: BLE001 - spill must never kill raylet
                logger.exception("proactive spill sweep failed")
            await asyncio.sleep(period)

    async def _metrics_flush_loop(self):
        """Core raylet metrics (stats/metric_defs.cc analog): sampled gauges
        over scheduler/worker-pool/object-store state, flushed to the GCS
        with the rest of this process's registry."""
        from ray_tpu_torch.util import metrics as metrics_api

        g_pending = metrics_api.Gauge(
            "raylet_pending_leases", "lease requests queued on this raylet"
        )
        g_active = metrics_api.Gauge(
            "raylet_active_leases", "leases currently holding resources"
        )
        g_workers = metrics_api.Gauge(
            "raylet_workers", "worker processes by state", tag_keys=("state",)
        )
        g_bytes = metrics_api.Gauge(
            "object_store_used_bytes", "bytes sealed in the local shm store"
        )
        g_objs = metrics_api.Gauge(
            "object_store_num_objects", "objects in the local shm store"
        )
        g_spill = metrics_api.Gauge(
            "object_store_num_spilled", "objects spilled to disk"
        )
        g_pinned = metrics_api.Gauge(
            "object_pinned_bytes",
            "bytes of objects under a live owner pin lease",
        )
        g_spilled_b = metrics_api.Gauge(
            "object_spilled_bytes", "bytes of objects backed by spill files"
        )
        g_state = metrics_api.Gauge(
            "object_lifecycle_state",
            "local objects by lifecycle state", tag_keys=("state",),
        )
        c_spilled = metrics_api.Counter(
            "object_spilled_total", "spill files written by this raylet"
        )
        c_restored = metrics_api.Counter(
            "object_restored_total",
            "spilled objects restored into shm by this raylet",
        )
        last_spills = last_restores = 0
        g_ticks = metrics_api.Gauge(
            "raylet_dispatch_ticks", "poll-loop iterations completed"
        )
        period = max(_config.metrics_report_interval_ms, 100) / 1000
        while True:
            try:
                rpc.publish_wire_counters()
                # raylet_pending_leases IS the sched-queue-depth series
                # (SLO dashboards/CLI read it by that name)
                g_pending.set(len(self.pending_leases))
                g_active.set(len(self.active_leases))
                by_state: Dict[str, int] = {}
                for w in self.pool.workers.values():
                    by_state[w.state] = by_state.get(w.state, 0) + 1
                for state, n in by_state.items():
                    g_workers.set(n, tags={"state": state})
                st = self.directory.stats()
                g_bytes.set(st.get("used_bytes", 0))
                g_objs.set(st.get("num_objects", 0))
                g_spill.set(st.get("num_spilled", 0))
                g_pinned.set(st.get("pinned_bytes", 0))
                g_spilled_b.set(st.get("spilled_bytes", 0))
                for state, n in (st.get("states") or {}).items():
                    g_state.set(n, tags={"state": state})
                c_spilled.inc(float(st.get("num_spills", 0) - last_spills))
                last_spills = st.get("num_spills", 0)
                c_restored.inc(
                    float(st.get("num_restores", 0) - last_restores))
                last_restores = st.get("num_restores", 0)
                g_ticks.set(getattr(self, "_poll_ticks", -1))
                for k, v in getattr(self, "_disp", {}).items():
                    metrics_api.Gauge(
                        f"raylet_dispatch_{k}",
                        "scheduler dispatch decisions since start",
                    ).set(v)
                samples = metrics_api.get_registry().collect()
                if samples and self.gcs is not None and not self.gcs.closed:
                    await self.gcs.notify(
                        "report_metrics",
                        source=f"raylet-{self.node_id}",
                        samples=samples,
                    )
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
            except Exception:  # noqa: BLE001 - metrics must never kill raylet
                logger.exception("metrics flush error")
            await asyncio.sleep(period)

    async def _task_events_flush_loop(self):
        """Flush this raylet's task events (lease grants) to the GCS
        aggregator — same plane the workers/drivers flush on. notify (not
        call): the raylet must never block on a GCS reply."""
        await tracing.events.flush_task_events_loop(
            tracing.get_buffer(), lambda: self.gcs,
            source=f"raylet-{self.node_id}", use_notify=True,
        )

    async def _spool_sweep_loop(self):
        """Session hygiene: reclaim stream spool files (``p<pid>_...``) in
        the session's ``cgraph_net/`` whose reader process died without
        releasing them (transport/stream.py::sweep_spool_dir)."""
        from ray_tpu_torch.core.object_store.shm_store import session_dir
        from ray_tpu_torch.core.transport import sweep_spool_dir

        spool_dir = os.path.join(session_dir(self.session), "cgraph_net")
        while True:
            await asyncio.sleep(30.0)
            try:
                await asyncio.get_event_loop().run_in_executor(
                    None, sweep_spool_dir, spool_dir
                )
            except Exception:  # noqa: BLE001 - hygiene must not kill the loop
                logger.exception("spool sweep failed")

    # ----------------------------------------------------------- scheduling
    def handle_worker_blocked(self, conn, worker_id: str):
        """A leased worker is blocking in get(): release its lease's
        resources and let the cap spawn replacements so its dependencies
        can run (reference: NotifyDirectCallTaskBlocked)."""
        w = self.pool.get_by_worker_id(worker_id)
        if w is None or not w.lease_id:
            return False
        entry = self.active_leases.get(w.lease_id)
        if entry is None or w.lease_id in self._blocked_leases:
            return False
        demand, worker, token = entry
        # the card stays held: the worker's CUDA context is on it
        self._release_token(token, self._without_gpu(demand))
        self._blocked_leases.add(w.lease_id)
        return True

    def handle_worker_unblocked(self, conn, worker_id: str):
        """The worker's get() returned: re-acquire its resources when
        available; if the node is briefly oversubscribed, the lease stays
        marked so return_lease won't double-release."""
        w = self.pool.get_by_worker_id(worker_id)
        if w is None or not w.lease_id:
            return False
        if w.lease_id not in self._blocked_leases:
            return False
        entry = self.active_leases.get(w.lease_id)
        if entry is None:
            self._blocked_leases.discard(w.lease_id)
            return False
        demand, worker, _ = entry
        pg_id, bundle_index = self._lease_pg.get(w.lease_id, (None, -1))
        token = self._acquire(self._without_gpu(demand), pg_id, bundle_index)
        if token is not None:
            self.active_leases[w.lease_id] = (demand, worker, token)
            self._blocked_leases.discard(w.lease_id)
        # else: stay blocked-marked; resources re-sync at return_lease
        return True

    def handle_cancel_lease_request(self, conn, req_id: str):
        """Owner no longer needs a QUEUED lease request (its demand was
        served by a cached lease). Parity: the reference's lease-request
        cancellation (ReplyCanceled) — without it, stale queued requests
        pile up and FIFO grant order starves other scheduling keys."""
        for lr in self.pending_leases:
            if lr.req_id == req_id:
                self.pending_leases.remove(lr)
                if not lr.future.done():
                    lr.future.set_result({"canceled": True})
                return True
        return False  # already granted (or unknown): caller pools the grant

    async def handle_request_lease(
        self, conn, resources, allow_spillback=True, pg_id=None,
        bundle_index=-1, req_id=None, task_id=None, task_name="",
        trace_id=None, arg_hints=None,
    ):
        """Owner asks for a worker lease. Replies:
        {granted: worker_addr, lease_id} | {spillback: raylet_addr} |
        {infeasible: True} (never schedulable here or anywhere known)."""
        demand = ResourceSet(resources)
        if pg_id is not None:
            if not any(k[0] == pg_id for k in self.bundles):
                return {"infeasible": True, "reason": "bundle not on this node"}
            if bundle_index >= 0 and (pg_id, bundle_index) not in self.bundles:
                return {"infeasible": True, "reason": "bundle not on this node"}
        # NB: a demand this node can never fit still QUEUES — the gossiped
        # cluster view may be seconds stale; _dispatch retries spillback each
        # tick and only declares infeasibility after the lease timeout
        # (reference: infeasible tasks stay queued, cluster_task_manager).
        lease = LeaseRequest(
            lease_id=uuid.uuid4().hex,
            demand=demand,
            future=asyncio.get_running_loop().create_future(),
            allow_spillback=allow_spillback and pg_id is None,
            pg_id=pg_id,
            bundle_index=bundle_index,
            owner_conn=conn,
            req_id=req_id,
            task_id=task_id,
            task_name=task_name or "",
            trace_id=trace_id,
            arg_hints=arg_hints or None,
        )
        self.pending_leases.append(lease)
        await self._dispatch()
        reply = await lease.future
        if "granted" in reply and conn is not None:
            # remember who holds it: cached leases (owner-side lease reuse)
            # must be reclaimed when the owner's connection drops, or a
            # crashed driver strands LEASED workers forever
            self._lease_owners.setdefault(conn, set()).add(reply["lease_id"])
        return reply

    async def handle_request_lease_batch(
        self, conn, resources, count, pg_id=None, bundle_index=-1,
        arg_hints=None,
    ):
        """Batched lease requests (dispatch-plane batching): an owner whose
        scheduling key has backlog asks for `count` leases in ONE rpc
        instead of `count` round trips. Replies with the per-lease result
        dicts ({granted}/{spillback}/{backlogged}/{infeasible}), all in one
        frame."""
        count = max(1, min(int(count), 64))
        if pg_id is not None:
            if not any(k[0] == pg_id for k in self.bundles) or (
                    bundle_index >= 0
                    and (pg_id, bundle_index) not in self.bundles):
                return [
                    {"infeasible": True, "reason": "bundle not on this node"}
                ] * count
        leases = []
        for _ in range(count):
            leases.append(LeaseRequest(
                lease_id=uuid.uuid4().hex,
                demand=ResourceSet(resources),
                future=asyncio.get_running_loop().create_future(),
                allow_spillback=pg_id is None,
                pg_id=pg_id,
                bundle_index=bundle_index,
                owner_conn=conn,
                arg_hints=arg_hints or None,
            ))
        self.pending_leases.extend(leases)
        await self._dispatch()
        # Non-blocking by design: grant whatever fits NOW, answer
        # {backlogged: True} for the rest instead of queueing them. A
        # gather over queued futures here held granted workers hostage
        # inside a reply that could never complete while the cluster was
        # saturated (the queued sub-leases only resolve when capacity
        # frees, which cached-lease reuse prevents) — the authoritative
        # blocking path stays the single request_lease.
        replies = []
        for lr in leases:
            if lr.future.done():
                replies.append(lr.future.result())
            else:
                lr.future.set_result({"backlogged": True})
                try:
                    self.pending_leases.remove(lr)
                except ValueError:
                    pass
                replies.append({"backlogged": True})
        for reply in replies:
            if "granted" in reply and conn is not None:
                self._lease_owners.setdefault(conn, set()).add(
                    reply["lease_id"]
                )
        return replies

    def _spawnable_demand(self) -> int:
        """How many queued leases could hold resources CONCURRENTLY right
        now — a greedy pack of pending demands into the available set.
        Zero-demand leases (num_cpus=0) always count: they need a worker
        but no resources."""
        avail = self.available
        n = 0
        for lease in self.pending_leases:
            if lease.future.done():
                continue
            if lease.pg_id is not None:
                n += 1  # draws from the bundle reservation, already carved
                continue
            if avail.fits(lease.demand):
                avail = avail.subtract(lease.demand)
                n += 1
        return n

    def _fits_now(self, lease: LeaseRequest) -> bool:
        """Non-destructive twin of _acquire_for: could this lease take
        resources right now? (Gates worker spawning: no point adding a
        worker for a lease whose RESOURCES are the shortage.)"""
        if lease.pg_id is not None:
            keys = (
                [(lease.pg_id, lease.bundle_index)]
                if lease.bundle_index >= 0
                else [k for k in self.bundle_free if k[0] == lease.pg_id]
            )
            return any(
                self.bundle_free.get(k) is not None
                and self.bundle_free[k].fits(lease.demand)
                for k in keys
            )
        return self.available.fits(lease.demand)

    def _acquire_for(self, lease: LeaseRequest) -> Optional[object]:
        return self._acquire(lease.demand, lease.pg_id, lease.bundle_index)

    def _acquire(self, demand: ResourceSet, pg_id=None,
                 bundle_index: int = -1) -> Optional[object]:
        """Try to take resources for a lease or actor. Returns an opaque
        release token or None. PG consumers draw from the bundle's
        reservation; plain ones from node availability."""
        if pg_id is not None:
            keys = (
                [(pg_id, bundle_index)]
                if bundle_index >= 0
                else sorted(k for k in self.bundle_free if k[0] == pg_id)
            )
            for key in keys:
                free = self.bundle_free.get(key)
                if free is not None and free.fits(demand):
                    self.bundle_free[key] = free.subtract(demand)
                    return ("bundle", key)
            return None
        if self.available.fits(demand):
            self.available = self.available.subtract(demand)
            return ("node", None)
        return None

    def _cards_fit(self, cards: List[str], gpus: float) -> bool:
        """Whether a worker bound to ``cards`` can take a lease of ``gpus``:
        its CUDA context stays on the cards of its first GPU lease."""
        if gpus >= 1:
            return len(cards) == int(gpus) and all(
                self._card_free[c] >= 1.0 for c in cards)
        return len(cards) == 1 and self._card_free[cards[0]] >= gpus

    def _take_cards(self, gpus: float, only: Optional[List[str]] = None
                    ) -> Optional[List[Tuple[str, float]]]:
        """Name the cards of a demand of ``gpus``: whole free cards for one
        or more, else the fullest card that still fits the share (so shares
        pack onto as few cards as they can). ``only`` is the worker's
        binding. None when the free shares cannot hold it."""
        if gpus <= 0:
            return []
        if only is not None:
            if not self._cards_fit(only, gpus):
                return None
            taken = [(c, min(1.0, gpus)) for c in only]
        elif gpus >= 1:
            free = [c for c, f in self._card_free.items() if f >= 1.0]
            if len(free) < int(gpus):
                return None
            taken = [(c, 1.0) for c in free[:int(gpus)]]
        else:
            fits = [c for c, f in self._card_free.items() if f >= gpus]
            if not fits:
                return None
            taken = [(min(fits, key=self._card_free.get), gpus)]
        for c, share in taken:
            self._card_free[c] -= share
        return taken

    def _give_back_cards(self, taken) -> None:
        for c, share in taken or ():
            self._card_free[c] += share

    @staticmethod
    def _without_gpu(demand: ResourceSet) -> ResourceSet:
        return ResourceSet.from_fixed_dict(
            {k: v for k, v in demand.fixed().items() if k != "GPU"})

    def _release_token(self, token, demand: ResourceSet):
        kind, key = token
        if kind == "bundle":
            free = self.bundle_free.get(key)
            if free is not None:
                self.bundle_free[key] = free.add(demand)
        else:
            self.available = self.available.add(demand)

    def _spillback_target(self, demand: ResourceSet,
                          require_available: bool = False,
                          arg_hints=None) -> Optional[str]:
        views = []
        for nid, v in self.cluster_view.items():
            if nid == self.node_id or not v.get("alive"):
                continue
            views.append(
                NodeView(
                    node_id=nid,
                    total=ResourceSet(v["total"]),
                    available=ResourceSet(v["available"]),
                )
            )
        if arg_hints:
            # weigh resident-arg bytes against utilization: among peers
            # that can run it NOW, the one already holding the largest
            # args wins (scheduling_policy.locality_policy)
            pick = locality_policy(
                demand, views, arg_hints, _config.locality_weight
            )
        else:
            pick = hybrid_policy(demand, views)
        if pick is None:
            if require_available:
                # busy-node offload must target free capacity ONLY: falling
                # back to could-ever-fit nodes ping-pongs leases between two
                # busy peers until the driver's hop bound trips
                return None
            # any node that could EVER fit it (this node never can)
            for v in views:
                if v.total.fits(demand):
                    return self.cluster_view[v.node_id]["address"]
            return None
        return self.cluster_view[pick]["address"]

    async def _dispatch(self):
        """One scan over queued leases (parity:
        LocalTaskManager::DispatchScheduledTasksToWorkers). Leases this node
        can never fit resolve via spillback/timeout without blocking others;
        fit-able leases grant FIFO as resources + idle workers allow. A
        spilled lease keeps its demand unchanged: the raylet that grants it
        names its cards."""
        now = time.monotonic()
        for lease in list(self.pending_leases):
            self._disp["seen"] += 1
            if lease.future.done():
                self._disp["done"] += 1
                self.pending_leases.remove(lease)
                continue
            never_fits_here = lease.pg_id is None and not self.total.fits(
                lease.demand
            )
            if never_fits_here:
                if lease.allow_spillback:
                    target = self._spillback_target(
                        lease.demand, arg_hints=lease.arg_hints
                    )
                    if target:
                        self._spill(lease, target)
                        continue
                if now - lease.queued_at > _config.worker_lease_timeout_ms / 1000:
                    self.pending_leases.remove(lease)
                    lease.future.set_result(
                        {"infeasible": True, "reason": "no node can fit demand"}
                    )
                continue
            target = self._locality_target(lease)
            if target is not None:
                self._disp["locality_spillbacks"] = (
                    self._disp.get("locality_spillbacks", 0) + 1
                )
                self.pending_leases.remove(lease)
                lease.future.set_result({"spillback": target})
                continue
            if not lease.prefetched and (
                    self._fits_now(lease)
                    or now - lease.queued_at >= 0.5):
                # start pulling remote args only once the lease is likely
                # to GRANT here: resources fit now (just waiting on a
                # worker), or it outlived the busy-node offload grace
                # without a peer taking it
                lease.prefetched = True
                self._prefetch_args(lease)
            gpus = lease.demand.get("GPU")
            idle = self.pool.idle_workers()
            if gpus:
                # a GPU lease goes to a worker bound to cards that fit it,
                # else to one that has touched no card yet
                idle = sorted(
                    (w for w in idle if w.gpu_ids is None
                     or self._cards_fit(w.gpu_ids, gpus)),
                    key=lambda w: w.gpu_ids is None,
                )
            if not idle:
                self._disp["skipped_no_worker"] += 1
                if not self._fits_now(lease):
                    # resources are the shortage, not workers: a spawn here
                    # adds an idle process that can never be leased (seen as
                    # 4 useless workers per 50-task burst on a saturated
                    # node — pure scheduler thrash on small boxes)
                    self._disp["skipped_no_resources"] += 1
                    # busy here: offload as below. The reference reaches its
                    # offload only with an idle worker on this node, so a
                    # node whose one worker is busy kept the lease queued
                    # behind it (ROADMAP Queue C). A lease whose args lie
                    # here waits for them instead.
                    if not self._holds_args(lease):
                        self._offload_if_busy(lease, now)
                    continue
                starting = sum(
                    1 for w in self.pool.workers.values() if w.state == "STARTING"
                )
                blocked_workers = {
                    self.active_leases[lid][1].startup_token
                    for lid in self._blocked_leases
                    if lid in self.active_leases
                }
                alive = sum(
                    1 for w in self.pool.workers.values()
                    if w.state != DEAD and w.startup_token not in blocked_workers
                )
                if gpus and alive >= self._worker_cap():
                    # at the cap, every idle worker bound to other cards:
                    # retire one so a worker for these cards can start
                    bound = [w for w in self.pool.idle_workers()
                             if w.gpu_ids is not None]
                    if bound:
                        self.pool.kill_worker(bound[0])
                        alive -= 1
                # spawn at most one per tick, only when the pipeline of
                # starting workers doesn't already cover the demand that can
                # actually RUN concurrently (not the raw queue length — a
                # 50-deep backlog on 4 CPU slots can use at most 4 workers)
                if (starting < self._spawnable_demand()
                        and alive < self._worker_cap()):
                    self.pool.start_worker()
                continue
            token = self._acquire_for(lease)
            if token is None:
                self._disp["skipped_no_resources"] += 1
                self._offload_if_busy(lease, now)
                continue
            worker = idle[0]
            cards = self._take_cards(gpus, worker.gpu_ids)
            if cards is None:  # the count fits, the cards' shares do not
                self._release_token(token, lease.demand)
                continue
            if cards:
                worker.gpu_ids = [c for c, _ in cards]
                self._lease_cards[lease.lease_id] = cards
            worker.state = LEASED
            worker.lease_id = lease.lease_id
            self.active_leases[lease.lease_id] = (lease.demand, worker, token)
            self._disp["grants"] += 1
            self._observe_lease_grant(lease)
            self._record_locality(lease)
            if lease.pg_id is not None:
                self._lease_pg[lease.lease_id] = (lease.pg_id, lease.bundle_index)
            self.pending_leases.remove(lease)
            reply = {"granted": worker.address, "lease_id": lease.lease_id,
                     "worker_id": worker.worker_id}
            if cards:
                reply["gpu_ids"] = worker.gpu_ids
            lease.future.set_result(reply)
            if lease.task_id is not None:
                tracing.get_buffer().record(
                    task_id=lease.task_id, name=lease.task_name,
                    state="LEASED", node_id=self.node_id,
                    worker=worker.address, trace_id=lease.trace_id,
                    component="raylet",
                )
            logger.debug("lease %s granted -> %s", lease.lease_id[:8], worker.address)

    def _worker_cap(self) -> int:
        cap = _config.num_workers_soft_limit
        if cap <= 0:
            cap = max(4, int(self.total.get("CPU")) * 2)
        return cap

    def _offload_if_busy(self, lease: LeaseRequest, now: float) -> None:
        """Resources busy here: after a grace period, offload to a peer with
        free capacity NOW (never to another busy node)."""
        if lease.allow_spillback and now - lease.queued_at >= 0.5:
            target = self._spillback_target(
                lease.demand, require_available=True,
                arg_hints=lease.arg_hints,
            )
            if target:
                self._spill(lease, target)
            else:
                self._report_wake.set()  # read a fresher view

    def _holds_args(self, lease: LeaseRequest) -> bool:
        """Whether this node (with its session peers) holds a chunk's worth
        of the lease's hinted arg bytes — the significance threshold of
        _locality_target."""
        if not lease.arg_hints:
            return False
        local = sum(locality_score(lease.arg_hints, nid)
                    for nid in self._session_local_nodes())
        return local >= _config.pull_chunk_bytes

    def _spill(self, lease: LeaseRequest, target: str) -> None:
        """Answer a queued lease with a spillback target (demand unchanged:
        the owner asks the target raylet for the same resources)."""
        self._disp["spillbacks"] += 1
        self.pending_leases.remove(lease)
        lease.future.set_result({"spillback": target})

    # ---------------------------------------------------- locality helpers
    def _locality_target(self, lease: LeaseRequest) -> Optional[str]:
        """Locality-preferred spillback: a feasible PEER already holding
        strictly more of the lease's hinted arg bytes than this node takes
        the lease (checked once per lease — the receiving raylet holds the
        bytes, so it grants locally and there is no ping-pong)."""
        if (not lease.arg_hints or not lease.allow_spillback
                or lease.locality_checked
                or _config.locality_weight <= 0):
            return None
        lease.locality_checked = True
        # bytes on any SAME-SESSION node are local: its shm dir is ours
        # (cluster_utils single-host clusters share one session), so a
        # spillback there would pay a lease hop to save zero transfer
        local = sum(
            locality_score(lease.arg_hints, nid)
            for nid in self._session_local_nodes()
        )
        best_nid, best = None, local
        for nid, v in self.cluster_view.items():
            if (nid == self.node_id or not v.get("alive")
                    or v.get("session") == self.session):
                continue
            score = locality_score(lease.arg_hints, nid)
            if score > best and ResourceSet(v["available"]).fits(lease.demand):
                best_nid, best = nid, score
        # only a CHUNK-sized advantage justifies a lease round-trip — for
        # sub-pull_chunk_bytes args the transfer is cheaper than the hop
        # (same significance threshold the owner's scheduling key uses)
        if best_nid is None or best - local < _config.pull_chunk_bytes:
            return None
        return self.cluster_view[best_nid]["address"]

    def _session_local_nodes(self) -> set:
        """Node ids whose object bytes this node reads for free: itself
        plus every alive peer sharing its shm session."""
        out = {self.node_id}
        for nid, v in self.cluster_view.items():
            if v.get("alive") and v.get("session") == self.session:
                out.add(nid)
        return out

    def _record_locality(self, lease: LeaseRequest) -> None:
        """Grant-time proof counter: a hinted lease granted on the node
        holding the most hinted bytes is a locality HIT (zero transfer for
        its largest args), anything else a miss."""
        if not lease.arg_hints:
            return
        session_local = self._session_local_nodes()
        local = sum(
            locality_score(lease.arg_hints, nid) for nid in session_local
        )
        best_remote = max(
            (locality_score(lease.arg_hints, nid)
             for nid, v in self.cluster_view.items()
             if nid not in session_local and v.get("alive")),
            default=0,
        )
        hit = local >= best_remote and local > 0
        key = "locality_hits" if hit else "locality_misses"
        self._disp[key] = self._disp.get(key, 0) + 1
        if not _config.metrics_enabled:
            return
        if self._m_locality is None:
            from ray_tpu_torch.util import metrics as metrics_api

            self._m_locality = (
                metrics_api.Counter(
                    "lease_locality_hits_total",
                    "hinted leases granted on the node holding the most "
                    "arg bytes",
                ),
                metrics_api.Counter(
                    "lease_locality_misses_total",
                    "hinted leases granted off the best arg-holding node",
                ),
            )
        self._m_locality[0 if hit else 1].inc(1.0)


    def _prefetch_args(self, lease: LeaseRequest) -> None:
        """Arg prefetch: start pulling a queued lease's REMOTE hinted args
        while the lease waits for resources/a worker, overlapping transfer
        with scheduling delay (the worker otherwise pulls serially at
        arg-decode time). Background priority: never ahead of a running
        task's own arg pull."""
        if not _config.arg_prefetch_enabled or not lease.arg_hints:
            return
        for oid_hex, nbytes, nid in lease.arg_hints:
            if nid == self.node_id or not nbytes:
                continue
            peer = self.cluster_view.get(nid)
            if (peer is None or not peer.get("alive")
                    or peer.get("session") == self.session):
                continue  # same session = same shm dir, nothing to move
            oid = ObjectID.from_hex(oid_hex)
            if self.shm.contains(oid):
                continue
            self._disp["prefetches"] = self._disp.get("prefetches", 0) + 1
            self._hold(asyncio.ensure_future(self.pulls.pull(
                oid, peer.get("address"), nbytes=nbytes, priority="prefetch",
            )))

    def handle_return_lease(self, conn, lease_id):
        entry = self.active_leases.pop(lease_id, None)
        if conn is not None and conn in self._lease_owners:
            self._lease_owners[conn].discard(lease_id)
        if entry is None:
            return False
        demand, worker, token = entry
        self._lease_pg.pop(lease_id, None)
        self._give_back_cards(self._lease_cards.pop(lease_id, None))
        if lease_id in self._blocked_leases:
            self._blocked_leases.discard(lease_id)  # released but the GPU
            self._release_token(token, demand.subtract(
                self._without_gpu(demand)))
        else:
            self._release_token(token, demand)
        if worker.state == LEASED:
            worker.state = IDLE
            worker.lease_id = None
        # re-dispatch immediately: queued leases must not wait for the next
        # 50 ms poll tick (that cap showed up as ~80 task/s in the
        # microbenchmark — one dispatch round per tick)
        if self.pending_leases:
            self._hold(asyncio.ensure_future(self._dispatch()))
        return True

    def handle_return_leases(self, conn, lease_ids):
        """Batched return_lease: the owner's idle-TTL reaper returns whole
        groups of cached leases in one rpc."""
        for lease_id in lease_ids:
            self.handle_return_lease(conn, lease_id)
        return True

    # ------------------------------------------------------------- workers
    def handle_register_worker(self, conn, startup_token, worker_id, address):
        handle = self.pool.on_register(startup_token, worker_id, address, conn)
        logger.info(
            "worker registered token=%s addr=%s ok=%s",
            startup_token, address, handle is not None,
        )
        if handle is None:
            return None
        reply = {
            "node_id": self.node_id,
            "session": self.session,
            "actor_id": handle.actor_id,
        }
        if handle.actor_id is not None:
            reply["actor_spec"] = self._actor_specs.get(handle.actor_id)
        return reply

    async def _on_worker_death(self, handle: WorkerHandle):
        await self._recover_worker_wal(handle)
        self._reclaim_worker_spools(handle)
        if handle.lease_id:
            self.handle_return_lease(None, handle.lease_id)
        if handle.actor_id is not None:
            entry = self._actor_resources.pop(handle.actor_id, None)
            if entry is not None:
                token, demand = entry
                self._release_token(token, demand)
            self._give_back_cards(self._actor_cards.pop(handle.actor_id, None))
            try:
                await self.gcs.call(
                    "actor_failed",
                    actor_id=handle.actor_id,
                    reason=f"worker process died (exit {handle.proc.returncode})",
                )
            except (rpc.RpcError, rpc.ConnectionLost):
                pass

    async def _recover_worker_wal(self, handle: WorkerHandle):
        """Crash forensics: a dead worker's unflushed TaskEventBuffer died
        with it — but its WAL (appended per event, truncated on successful
        flush) survives in the session dir. Forward the orphaned tail to the
        aggregator so a SIGKILLed worker's final spans (RUNNING states,
        profile spans from the last second) still close its timeline, then
        delete the file (recovery is one-shot)."""
        if not _config.task_events_wal_enabled:
            return
        from ray_tpu_torch.core.object_store.shm_store import session_dir

        path = os.path.join(
            session_dir(self.session), "task_wal",
            f"wal-{self.node_id}-{handle.startup_token}.jsonl",
        )
        try:
            events = tracing.read_wal(path)
        except Exception:  # noqa: BLE001 - forensics must not break reaping
            logger.exception("WAL parse failed for %s", path)
            return
        if not events:
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        # deliver BEFORE unlinking: if the GCS is unreachable right now,
        # the file stays and the orphan sweep retries once it is back
        # (replay is idempotent — the aggregator dedups wal- sources)
        if not await self._report_wal_events(
            events, f"wal-{self.node_id}-{handle.startup_token}"
        ):
            return
        logger.info(
            "recovered %d task events from dead worker token=%s WAL",
            len(events), handle.startup_token,
        )
        try:
            os.unlink(path)
        except OSError:
            pass

    async def _report_wal_events(self, events, source: str) -> bool:
        if self.gcs is None or self.gcs.closed:
            return False
        try:
            await self.gcs.notify(
                "report_task_events", events=events, dropped=0,
                source=source,
            )
            return True
        except (rpc.RpcError, rpc.ConnectionLost):
            return False

    def _reclaim_worker_spools(self, handle: WorkerHandle) -> None:
        """A worker died: unlink any cross-node channel spool files it
        still pinned in the session's ``cgraph_net/`` dir (a SIGKILLed
        stream reader never ran its release path — without this they
        lingered until session teardown). The periodic session sweep
        backstops workers that die with the raylet."""
        from ray_tpu_torch.core.object_store.shm_store import session_dir

        spool_dir = os.path.join(session_dir(self.session), "cgraph_net")
        pid = getattr(handle.proc, "pid", None)
        if pid is None:
            return
        prefix = f"p{pid}_"
        try:
            names = os.listdir(spool_dir)
        except OSError:
            return
        removed = 0
        for name in names:
            if name.startswith(prefix):
                try:
                    os.unlink(os.path.join(spool_dir, name))
                    removed += 1
                except OSError:
                    pass
        if removed:
            logger.info(
                "reclaimed %d spool file(s) of dead worker pid=%d",
                removed, pid,
            )

    # -------------------------------------------------------------- actors
    async def handle_create_actor_worker(self, conn, actor_id, spec_blob,
                                         resources, pg_id=None, bundle_index=-1):
        """Spawn a dedicated worker for an actor. PG actors draw their
        resources from the bundle's reservation (same as PG task leases in
        _acquire_for) — NOT from node availability, which the bundle already
        debited; double-booking starved plain tasks (round-3 fix)."""
        existing = self.pool.get_actor_worker(actor_id)
        if existing is not None and existing.address:
            # GCS restarted (fault tolerance) and is rescheduling an actor
            # that never died: adopt the live worker instead of spawning a
            # duplicate (which would also double-book its resources)
            self._hold(asyncio.ensure_future(
                self._announce_adopted_actor(actor_id, existing.address)
            ))
            return True
        demand = ResourceSet(resources)
        token = self._acquire(demand, pg_id, bundle_index)
        if token is None:
            # GCS picked us from a stale view (or the wrong bundle node);
            # let it retry elsewhere
            raise RuntimeError(
                "placement-group bundle cannot fit actor" if pg_id is not None
                else "resources no longer available"
            )
        cards = self._take_cards(demand.get("GPU"))
        if cards is None:
            self._release_token(token, demand)
            raise RuntimeError("no card has the actor's GPU share free")
        self._actor_specs[actor_id] = spec_blob
        self._actor_resources[actor_id] = (token, demand)
        gpu_ids = [c for c, _ in cards] or None
        if cards:
            self._actor_cards[actor_id] = cards
        handle = self.pool.start_worker(actor_id=actor_id, gpu_ids=gpu_ids)
        handle.state = ACTOR
        return True

    async def _announce_adopted_actor(self, actor_id, address):
        """actor_ready for an adopted live worker, retried: if the one-shot
        notify is lost (GCS reconnect window) the actor would sit PENDING
        forever — no other sender exists for an already-initialized actor."""
        for _ in range(20):
            try:
                if self.gcs is not None and not self.gcs.closed:
                    await self.gcs.call(
                        "actor_ready", actor_id=actor_id,
                        address=address, node_id=self.node_id, timeout=10,
                    )
                    return
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
            await asyncio.sleep(0.5)
        logger.warning("adopted-actor announce failed for %s", actor_id.hex())

    async def handle_kill_actor_worker(self, conn, actor_id):
        handle = self.pool.get_actor_worker(actor_id)
        if handle:
            self.pool.kill_worker(handle)
            # kill_worker marks the handle DEAD, so poll_deaths never routes
            # this through _on_worker_death — release the actor's resources
            # here or the node permanently leaks them.
            entry = self._actor_resources.pop(actor_id, None)
            if entry is not None:
                token, demand = entry
                self._release_token(token, demand)
            self._give_back_cards(self._actor_cards.pop(actor_id, None))
            if handle.lease_id:
                self.handle_return_lease(None, handle.lease_id)
            return True
        return False

    # ---------------------------------------------------- placement groups
    def handle_reserve_bundle(self, conn, pg_id, bundle_index, resources):
        demand = ResourceSet(resources)
        if (pg_id, bundle_index) in self.bundles:
            # idempotent: a store-restored GCS re-places detached PGs whose
            # bundles this raylet still holds — don't double-subtract
            return True
        if not self.available.fits(demand):
            return False
        self.available = self.available.subtract(demand)
        self.bundles[(pg_id, bundle_index)] = demand
        self.bundle_free[(pg_id, bundle_index)] = demand
        return True

    def handle_release_bundle(self, conn, pg_id, bundle_index):
        demand = self.bundles.pop((pg_id, bundle_index), None)
        self.bundle_free.pop((pg_id, bundle_index), None)
        if demand is not None:
            self.available = self.available.add(demand)
        return True

    # ------------------------------------------------------------- objects
    def handle_object_added(self, conn, oid_hex, nbytes):
        """An owner sealed a shm object here: it enters the lifecycle
        machine as a pinned PRIMARY (the notifier IS the owner, so the add
        doubles as the first pin lease; renewals arrive on the owner's
        metadata batch plane)."""
        oid = ObjectID.from_hex(oid_hex)
        self.directory.add(oid, nbytes, role="primary")
        self.directory.pin(oid, _config.object_pin_ttl_s)
        return True

    def handle_object_added_batch(self, conn, entries):
        """Batched location records: owners flush (oid, nbytes) pairs in
        groups off the put/return hot path."""
        for oid_hex, nbytes in entries:
            oid = ObjectID.from_hex(oid_hex)
            self.directory.add(oid, nbytes, role="primary")
            self.directory.pin(oid, _config.object_pin_ttl_s)
        return True

    def handle_pin_objects(self, conn, entries):
        """Owner pin-lease renewal (batched on the owner-metadata plane):
        extend each primary's lease by the configured TTL. Unknown oids
        are ignored — the owner may be renewing something already freed."""
        n = 0
        for oid_hex in entries:
            if self.directory.pin(ObjectID.from_hex(oid_hex),
                                  _config.object_pin_ttl_s):
                n += 1
        return n

    def handle_promote_primary(self, conn, oids_hex):
        """GCS death path: this node's SECONDARY copies of a dead node's
        primaries become the authoritative PRIMARY copies (lifecycle
        SECONDARY -> PRIMARY edge). Returns the subset actually held."""
        promoted = []
        for oid_hex in oids_hex:
            if self.directory.promote(ObjectID.from_hex(oid_hex)):
                promoted.append(oid_hex)
        return promoted

    async def handle_adopt_spill(self, conn, entries):
        """GCS death path, no in-memory survivor: adopt a dead same-host
        raylet's spill files (path, nbytes, crc all GCS-registered at
        spill time). The crc re-verify + file read run on an executor
        thread. Returns the oids adopted; the GCS re-registers them under
        this node so pulls and restores route here."""
        adopted = []
        loop = asyncio.get_running_loop()
        for oid_hex, path, nbytes, crc in entries:
            ok = await loop.run_in_executor(
                None, self.directory.adopt_spill,
                ObjectID.from_hex(oid_hex), path, nbytes, crc,
            )
            if ok:
                adopted.append(oid_hex)
        return adopted

    def handle_object_stats(self, conn):
        return self.directory.stats()

    def handle_free_objects(self, conn, oids_hex):
        oids = [ObjectID.from_hex(h) for h in oids_hex]
        for oid in oids:
            # delete() fires the eviction listener for every record it
            # drops (spill-backed included), which deregisters the GCS
            # locations via _drop_secondaries — no direct call needed
            self.directory.delete(oid)
        return True

    async def handle_fetch_object(self, conn, oid_hex):
        """Peer raylet (or local client) reads object bytes for transfer.

        The reply rides the frame's out-of-band segment table straight from
        the sealed object's mmap — no copy into the response pickle. The
        The ShmBuffer's mapping stays pinned until the frame is written:
        the frame encoder puts the raw buffer view itself into the outbox
        chunk list (Oob.keepalive additionally pins the ShmBuffer object
        through encode).
        """
        oid = ObjectID.from_hex(oid_hex)
        buf = self.shm.get(oid)
        if buf is None:
            if not self.directory.restore(oid):
                return None
            buf = self.shm.get(oid)
            if buf is None:
                return None
        self.directory.touch(oid)
        return rpc.Oob(buf.buffer, keepalive=buf)

    async def handle_pull_object(self, conn, oid_hex, source_addr,
                                 nbytes=None, priority="arg",
                                 transport=None, job_id=None):
        """Pull an object from a remote raylet into the local store.

        Parity: PullManager/PushManager — all inbound transfers funnel
        through ``self.pulls`` (dedup, inflight-bytes bound with task-arg
        priority, chunked stream-plane transfer with native-daemon and rpc
        fallbacks, typed capacity refusal). Replies
        ``{"ok": True}`` / ``{"ok": False, "reason": ...}``."""
        return await self.pulls.pull(
            ObjectID.from_hex(oid_hex), source_addr, nbytes=nbytes,
            priority=priority, transport=transport, job_id=job_id,
        )

    async def handle_push_chunks(self, conn, oid_hex, indices, nbytes,
                                 chunk_bytes, host, port, channel_id, token):
        """Source side of a chunked pull: stream the requested chunk
        indices of a locally-sealed object to the puller's ChunkReceiver
        (object_store/chunk_transfer.py). The transfer runs on an executor
        thread with the ShmBuffer pinned; the reply only acknowledges that
        the push STARTED — completion is the puller's receiver seeing its
        chunks land (a severed stream surfaces there as a missing set)."""
        oid = ObjectID.from_hex(oid_hex)
        buf = self.shm.get(oid)
        if buf is None:
            if not self.directory.restore(oid):
                return {"ok": False, "reason": "not local"}
            buf = self.shm.get(oid)
            if buf is None:
                return {"ok": False, "reason": "not local"}
        self.directory.touch(oid)
        self._pushes_served += 1
        from ray_tpu_torch.core.object_store import chunk_transfer

        def _push_and_release():
            try:
                chunk_transfer.push_chunks_blocking(
                    buf, oid_hex, indices, nbytes, chunk_bytes, host, port,
                    channel_id, token,
                )
            finally:
                buf.close()

        self._hold(asyncio.ensure_future(
            asyncio.get_running_loop().run_in_executor(
                self._push_pool, _push_and_release
            )
        ))
        return {"ok": True}

    def _on_objects_evicted(self, oids) -> None:
        """Directory eviction listener (arbitrary thread, lock released):
        deregister evicted SECONDARY copies from the GCS location table so
        no puller is ever routed to a holder that just dropped its copy."""
        self._drop_secondaries(oids)

    def _on_objects_spilled(self, entries) -> None:
        """Directory spill listener (arbitrary thread, lock released):
        register each new spill file's metadata (path, nbytes, crc) in the
        GCS secondary-copy directory, so the death path can hand the file
        to a surviving raylet on the same host."""
        if self._loop is None:
            return
        payload = [(oid.hex(), self.node_id, path, nbytes, crc)
                   for oid, path, nbytes, crc in entries]
        self._loop.call_soon_threadsafe(
            lambda: self._hold(asyncio.ensure_future(
                self._register_spills(payload)
            ))
        )

    async def _register_spills(self, entries) -> None:
        if self.gcs is None or self.gcs.closed:
            return
        try:
            await self.gcs.notify("object_location_spill", entries=entries)
        except (rpc.RpcError, rpc.ConnectionLost):
            pass  # soft state: the copy just isn't adoptable after a death

    def _drop_secondaries(self, oids) -> None:
        """Single teardown path for vanished local copies (free, evict):
        forget them in the pull manager and deregister them at the GCS.
        EVERY vanished oid is deregistered, not just advertised
        secondaries — a freed spill-backed primary was registered via
        object_location_spill, and leaving that entry behind would route
        pullers (and the death path's adoption) at a spill file that no
        longer exists. Unknown entries are a no-op at the GCS. Callable
        from ANY thread — the notify is trampolined onto the raylet loop
        (call_soon_threadsafe is loop-thread-safe too)."""
        self.pulls.on_local_drop(oids)
        if not oids or self._loop is None:
            return
        entries = [(oid.hex(), self.node_id) for oid in oids]
        self._loop.call_soon_threadsafe(
            lambda: self._hold(asyncio.ensure_future(
                self._deregister_locations(entries)
            ))
        )

    async def _deregister_locations(self, entries) -> None:
        if self.gcs is None or self.gcs.closed:
            return
        try:
            await self.gcs.notify("object_location_remove", entries=entries)
        except (rpc.RpcError, rpc.ConnectionLost):
            pass  # soft state; the GCS prunes dead nodes itself

    def handle_object_store_stats(self, conn):
        return self.directory.stats()

    def handle_scheduler_stats(self, conn):
        """Introspection for tests/CLI: dispatch decision counters
        (including locality hits/misses and prefetch kicks), pull-manager
        transport stats, and chunk ranges served to peers."""
        return {
            "dispatch": dict(self._disp),
            "pulls": dict(self.pulls.stats),
            "pushes_served": self._pushes_served,
            # this raylet's OWN gossiped view (what locality decisions see)
            "view": {
                nid: dict(v.get("available") or {})
                for nid, v in self.cluster_view.items()
                if v.get("alive")
            },
        }

    async def on_disconnection(self, conn):
        """An owner's connection dropped: reclaim every lease it still
        holds and drop its queued lease requests (parity: the reference
        raylet cancels leases on owner death)."""
        owned = list(self._lease_owners.pop(conn, ()))
        if owned:
            logger.info("owner %s disconnected with %d leases", conn, len(owned))
        for lease_id in owned:
            entry = self.active_leases.get(lease_id)
            worker = entry[1] if entry is not None else None
            was_leased = worker is not None and worker.state == LEASED
            self.handle_return_lease(None, lease_id)
            # The owner pushes tasks to the worker over a DIRECT connection
            # the raylet can't observe, so a LEASED worker may still be
            # mid-task for the dead owner. Recycling it to IDLE would let
            # the scheduler push a second concurrent task onto a busy
            # worker — kill it instead and let demand respawn a fresh one
            # (reference: raylet destroys leased workers on owner death).
            if was_leased and worker.actor_id is None:
                logger.info("killing mid-task worker token=%s pid=%s of dead owner",
                            worker.startup_token, worker.proc.pid)
                self.pool.kill_worker(worker)
        for lr in list(self.pending_leases):
            if lr.owner_conn is conn:
                self.pending_leases.remove(lr)
                if not lr.future.done():
                    lr.future.set_result({"infeasible": True,
                                          "reason": "owner disconnected"})


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--session", required=True)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=0)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--object-store-memory-mb", type=int, default=None)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    import json

    from ray_tpu_torch.core.resources import node_resources

    # the starting driver detected the cards (cluster_backend.start_raylet):
    # the raylet never asks CUDA, so it never holds a context on a card
    res = node_resources(
        num_cpus=int(args.num_cpus) if args.num_cpus is not None else None,
        num_gpus=int(args.num_gpus),
        custom=json.loads(args.resources),
        detect_gpus=False,
    )

    async def run():
        raylet = Raylet(
            gcs_address=args.gcs,
            session=args.session,
            node_id=args.node_id,
            resources=res,
            host=args.host,
            port=args.port,
            object_store_memory_mb=args.object_store_memory_mb,
        )
        addr = await raylet.start()
        print(f"RAYLET_ADDRESS={addr}", flush=True)
        # SIGTERM (the starting driver's shutdown) closes the raylet, which
        # kills and reaps its workers, so none outlives the cluster
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        await stop.wait()
        await raylet.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()

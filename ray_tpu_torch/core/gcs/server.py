"""GCS — the cluster control plane.

Parity: src/ray/gcs/gcs_server/ (gcs_server.cc:133-178 wires the same manager
set): node membership + health checks, KV store, function registry, actor
lifecycle + restarts, placement groups, resource view aggregation, pubsub.
Single asyncio process. Durability (the reference's Redis store_client,
src/ray/gcs/store_client/): every durable-table mutation appends to a
write-ahead log BEFORE its RPC reply is sent (core/gcs/wal.py), and a
periodic compaction replaces the log with a full-table snapshot that also
captures the soft state worth keeping across a restart (metrics ring,
task-event aggregator). Restore = snapshot + WAL replay, tolerant of a
torn final record — an unclean GCS death at ANY
instruction loses zero acknowledged mutations.

Connections are bidirectional: raylets register once and the same connection
carries GCS→raylet commands (create worker, kill, reserve bundle) — no
separate client channel needed.

The port's copy of ray_tpu/core/gcs/server.py: nodes and health checks, the
KV store, functions, jobs, actors with restarts, placement groups, pubsub
(logs, actor and node events), the snapshot + WAL of the durable tables,
the task-event aggregator (tracing) and the metrics registry merge and time
series (metrics) behind the state API. Cut with their planes: chaos
installs, the compiled-graph channel-endpoint registry (cgraph), the
autoscaler's cluster load (autoscaling), and the shipped task-event WAL
tails of dead nodes (whole-node-loss forensics). Nodes register with their
native transfer daemon's port; the secondary-copy object directory, with the
dead-node promotion of a surviving copy and the adoption of a dead node's
spill file, is the reference's.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import _config
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.core.scheduling_policy import NodeView, hybrid_policy, pack_bundles

logger = logging.getLogger(__name__)

# actor states (gcs.proto ActorTableData analog)
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


@dataclass
class NodeInfo:
    node_id: str
    address: str                     # raylet rpc address
    session: str                     # shm session name (object store)
    total: ResourceSet = field(default_factory=ResourceSet)
    available: ResourceSet = field(default_factory=ResourceSet)
    labels: Dict[str, str] = field(default_factory=dict)
    conn: Any = None
    alive: bool = True
    last_report: float = field(default_factory=time.monotonic)

    def view(self) -> NodeView:
        return NodeView(
            node_id=self.node_id,
            total=self.total,
            available=self.available,
            alive=self.alive,
            labels=self.labels,
        )

    def public(self) -> dict:
        return {
            "NodeID": self.node_id,
            "NodeManagerAddress": self.address,
            "Session": self.session,
            "Alive": self.alive,
            "Resources": self.total.to_dict(),
            "Available": self.available.to_dict(),
            "Labels": dict(self.labels),
        }


@dataclass
class ActorInfo:
    actor_id: bytes
    spec_blob: bytes                # pickled creation TaskSpec
    state: str = PENDING
    address: Optional[str] = None   # actor worker rpc address
    node_id: Optional[str] = None
    name: Optional[str] = None
    namespace: str = "default"
    detached: bool = False
    owner_conn: Any = None          # driver/worker connection that owns it
    restarts_left: int = 0
    max_restarts: int = 0
    resources: Dict[str, float] = field(default_factory=dict)
    death_reason: str = ""
    num_restarts: int = 0
    pg_id: Optional[bytes] = None
    bundle_index: int = -1
    sched_attempts: int = 0         # rotates unspecified-bundle placement

    def public(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id,
            "name": self.name,
            "namespace": self.namespace,
            "death_reason": self.death_reason,
            "num_restarts": self.num_restarts,
        }


@dataclass
class PlacementGroupInfo:
    pg_id: bytes
    bundles: List[Dict[str, float]]
    strategy: str
    state: str = "PENDING"
    placement: Optional[List[str]] = None  # node_id per bundle
    creator_conn: Any = None
    detached: bool = False


class GcsServer:
    def __init__(self, host="127.0.0.1", port=0, store_path: Optional[str] = None):
        self.server = rpc.RpcServer(self, host=host, port=port)
        # fault tolerance: durable tables snapshot to store_path (the
        # Redis-backed store_client of the reference, file-backed here);
        # a restarted GCS on the same address restores them and nodes/
        # drivers re-register over their reconnect loops
        self.store_path = store_path
        self.nodes: Dict[str, NodeInfo] = {}
        self.kv: Dict[Tuple[str, str], bytes] = {}
        self.functions: Dict[bytes, bytes] = {}
        self.actors: Dict[bytes, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}
        self.placement_groups: Dict[bytes, PlacementGroupInfo] = {}
        self.subscribers: Dict[str, Set[rpc.Connection]] = {}
        self.job_counter = 0
        self._conn_owned_actors: Dict[rpc.Connection, Set[bytes]] = {}
        self._conn_owned_pgs: Dict[rpc.Connection, Set[bytes]] = {}
        # object plane: secondary-copy directory (oid_hex -> {node_id:
        # {"nbytes", "spill"}}, insertion-ordered). Raylets register here
        # after a completed pull, register spill-file metadata (path,
        # nbytes, crc) when they spill, and deregister on eviction/free,
        # so later pullers of a hot object fetch from a spread of holders
        # (distribution tree) instead of hammering the owner node — and
        # the node-death path can promote a surviving holder or hand a
        # dead raylet's spill file to a live one. Soft state by design:
        # not snapshotted/WAL'd — after a GCS restart pulls fall back to
        # the owner-recorded primary location and the table re-fills.
        self.object_locations: Dict[str, Dict[str, dict]] = {}
        self._object_loc_rr: Dict[str, int] = {}
        # observability: bounded per-task event aggregation (GcsTaskManager
        # analog, gcs_task_manager.h:61) + monotonically-counted metrics
        from ray_tpu_torch.tracing import TaskEventAggregator

        self.task_events = TaskEventAggregator()
        self.metrics: Dict[str, int] = {}
        # metrics plane: {source: (ts, [series snapshots])} flushed by every
        # process's registry (util/metrics.py); dashboard /metrics renders
        # the merge, and a bounded ring of merged snapshots (sampled every
        # metrics_report_interval_ms) backs get_metrics_timeseries — "what
        # was p99 five minutes ago" without an external Prometheus.
        self.metric_reports: Dict[str, Tuple[float, list]] = {}
        from ray_tpu_torch.util.metrics import MetricsTimeSeries

        self.timeseries = MetricsTimeSeries()
        self._bg: List[asyncio.Task] = []
        # strong refs to one-shot retry tasks until done (the loop holds
        # tasks weakly: a bare ensure_future in a timer callback is
        # GC-able mid-flight — raylint RT003)
        self._held_tasks: set = set()
        self._store_dirty = True  # durable-table mutation since last snapshot
        # snapshot installs are serialized + ordered: the compaction loop
        # writes off-loop while close() writes synchronously on the loop
        # (task.cancel() does not stop an already-running executor thread,
        # and both paths share the same .tmp file); the generation counter
        # keeps a stale in-flight capture from clobbering a newer snapshot
        self._snap_lock = threading.Lock()
        self._snap_gen = 0  # bumped at capture time, on the event loop only
        self._snap_installed = 0  # generation of the snapshot on disk
        # write-ahead log (opened in start() after restore+replay); None
        # when persistence is off — mutations then live only in memory
        self.wal = None
        self._actor_events: Dict[bytes, asyncio.Event] = {}  # get_actor waits

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        if self.store_path:
            wal_seq = self._restore_store()
            if _config.gcs_wal_enabled:
                wal_seq = self._replay_wal(wal_seq)
                from ray_tpu_torch.core.gcs.wal import GcsWal

                self.wal = GcsWal(self._wal_base())
                self.wal.open(wal_seq)
            else:
                self._fold_leftover_wal(wal_seq)
            self._schedule_restored()
        await self.server.start()
        self._bg.append(asyncio.create_task(self._health_check_loop()))
        self._bg.append(asyncio.create_task(self._metrics_sample_loop()))
        if self.store_path:
            self._bg.append(asyncio.create_task(self._compaction_loop()))
        logger.info("GCS listening on %s", self.server.address)
        return self.server.address

    async def close(self):
        for t in self._bg:
            t.cancel()
        if self.store_path:
            await self._close_snapshot()
        if self.wal is not None:
            self.wal.close()
        await self.server.close()

    async def _close_snapshot(self) -> None:
        """Final snapshot on graceful close: same shape as a compaction —
        rotate + durable-table capture on the loop, heavy copy-outs +
        pickle + prune on the executor — but with a bounded wait instead
        of blocking the event loop synchronously. On timeout the sealed
        WAL segments still hold every acknowledged mutation, so nothing
        is lost; the next start just replays a longer log."""
        self._snap_gen += 1
        gen = self._snap_gen
        seq = self.wal.rotate() if self.wal is not None else 0
        state = self._snapshot_state(seq, include_heavy=False)

        def write():
            self._snapshot_heavy(state)
            self._install_snapshot(gen, state, seq)

        try:
            await asyncio.wait_for(
                asyncio.get_event_loop().run_in_executor(None, write),
                timeout=max(0.1, _config.gcs_close_snapshot_timeout_s),
            )
        except asyncio.TimeoutError:
            logger.warning(
                "close-time snapshot exceeded %.1fs; relying on the WAL",
                _config.gcs_close_snapshot_timeout_s,
            )

    # --------------------------------------------------- fault tolerance
    def _wal_base(self) -> str:
        return self.store_path + ".wal"

    def _append_wal(self, op: str, **data) -> None:
        """Durably log one table mutation. Called INSIDE the mutating
        handler, before it returns — the rpc reply (= the caller's
        acknowledgement) is only queued after the handler finishes, so an
        acknowledged mutation is always on disk."""
        if self.wal is not None:
            self.wal.append(op, data)

    def _fold_leftover_wal(self, after_seq: int) -> None:
        """`gcs_wal_enabled` was toggled OFF across a restart but segments
        from the previous (enabled) run exist: they hold acknowledged
        mutations past the snapshot. Skipping them would silently lose
        those mutations, and leaving them on disk is worse — snapshots
        written while disabled carry wal_seq=0, so a later re-ENABLED
        restart would replay the stale records over newer state,
        resurrecting deleted keys and dead actors. Replay them now, fold
        them into a fresh snapshot, and delete them."""
        from ray_tpu_torch.core.gcs import wal as wal_mod

        segs = wal_mod.list_segments(self._wal_base())
        if not segs:
            return
        logger.warning(
            "GCS WAL disabled but %d segment(s) from a previous run exist; "
            "replaying + folding them into the snapshot", len(segs),
        )
        self._replay_wal(after_seq)
        if self._write_snapshot_state(self._snapshot_state(0)):
            for _, path in segs:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _replay_wal(self, after_seq: int) -> int:
        from ray_tpu_torch.core.gcs import wal as wal_mod

        replayed = 0
        for seq, op, data in wal_mod.replay(self._wal_base(), after_seq):
            try:
                self._apply_wal(op, data)
            except Exception:  # noqa: BLE001 - one bad record: keep going
                logger.exception("WAL replay failed for op %r seq %d",
                                 op, seq)
            after_seq = seq
            replayed += 1
        if replayed:
            logger.info("GCS WAL replay: %d record(s) past snapshot", replayed)
            if _config.metrics_enabled:
                from ray_tpu_torch.util.metrics import Counter

                Counter(
                    "gcs_wal_replayed_total",
                    "WAL records replayed on GCS restore",
                ).inc(float(replayed))
        return after_seq

    def _apply_wal(self, op: str, d: dict) -> None:
        """Replay one durable record. Every op is an idempotent state SET
        (never an increment), so snapshot/replay overlap converges."""
        if op == "kv_put":
            self.kv[(d["ns"], d["key"])] = d["value"]
        elif op == "kv_del":
            self.kv.pop((d["ns"], d["key"]), None)
        elif op == "fn":
            self.functions[d["fn_id"]] = d["blob"]
        elif op == "job":
            self.job_counter = max(self.job_counter, int(d["value"]))
        elif op == "actor_put":
            self._restore_actor(d["aid"], d["entry"])
        elif op == "actor_dead":
            info = self.actors.pop(d["aid"], None)
            if info is not None and info.name and self.named_actors.get(
                    (info.namespace, info.name)) == d["aid"]:
                del self.named_actors[(info.namespace, info.name)]
        elif op == "pg_put":
            e = d["entry"]
            self.placement_groups[d["pg_id"]] = PlacementGroupInfo(
                pg_id=d["pg_id"], bundles=e["bundles"],
                strategy=e["strategy"], detached=True,
                placement=e.get("placement"),
                state="CREATED" if e.get("placement") else "PENDING",
            )
        elif op == "pg_del":
            self.placement_groups.pop(d["pg_id"], None)
        else:
            logger.warning("unknown WAL op %r ignored", op)

    @staticmethod
    def _actor_entry(i: "ActorInfo") -> dict:
        return {
            "spec_blob": i.spec_blob,
            "name": i.name,
            "namespace": i.namespace,
            "max_restarts": i.max_restarts,
            "restarts_left": i.restarts_left,
            "resources": i.resources,
            "pg_id": i.pg_id,
            "bundle_index": i.bundle_index,
            # adoption hint: reschedule on the node whose live worker
            # still runs this actor, never a duplicate elsewhere
            "node_id": i.node_id,
        }

    def _durable_state(self) -> dict:
        """Tables that must survive a GCS restart. Nodes/connections are NOT
        persisted: raylets and drivers re-register through their reconnect
        loops. Detached actors/PGs are restored PENDING and reschedule as
        nodes come back (parity: gcs/store_client tables)."""
        detached_actors = {
            aid: self._actor_entry(i)
            for aid, i in self.actors.items()
            if i.detached and i.state != DEAD
        }
        detached_pgs = {
            pg_id: {
                "bundles": p.bundles,
                "strategy": p.strategy,
                # re-adopt the exact bundle placement: the raylets still hold
                # these reservations (reserve_bundle is idempotent)
                "placement": p.placement,
            }
            for pg_id, p in self.placement_groups.items()
            if p.detached
        }
        return {
            "kv": dict(self.kv),
            "functions": dict(self.functions),
            "job_counter": self.job_counter,
            "actors": detached_actors,
            "named_actors": {
                k: v for k, v in self.named_actors.items()
                if v in detached_actors
            },
            "placement_groups": detached_pgs,
        }

    def _snapshot_state(self, wal_seq: int,
                        include_heavy: bool = True) -> dict:
        """Full-table snapshot: the durable tables plus the soft state a
        restarted head should not forget — the metrics time-series ring,
        the task-event aggregator and the last metric report per source.
        ``wal_seq`` marks the WAL prefix this snapshot covers (replay skips
        records at or below it). With ``include_heavy=False`` the
        lock-guarded heavy copy-outs are left for the caller to run off-loop
        via :meth:`_snapshot_heavy` — both snapshot paths share THIS field
        list, so a new soft-state field added here reaches the compaction
        path too."""
        state = self._durable_state()
        state["wal_seq"] = int(wal_seq)
        state["metrics"] = dict(self.metrics)
        state["metric_reports"] = dict(self.metric_reports)
        if include_heavy:
            self._snapshot_heavy(state)
        return state

    def _snapshot_heavy(self, state: dict) -> None:
        """The task-event + timeseries copy-outs: guarded by their own
        locks (safe off the event loop), and the aggregator copy grows
        with retained history — the compaction path runs these in the
        executor so they never stall heartbeat/scheduling rpcs."""
        state["timeseries"] = self.timeseries.dump()
        state["task_events"] = self.task_events.dump()

    def _write_snapshot(self) -> None:
        """Synchronous full snapshot (tests / offline tooling); the running
        server compacts through _compaction_loop and graceful close goes
        through _close_snapshot (bounded, off-loop)."""
        self._snap_gen += 1
        gen = self._snap_gen
        seq = self.wal.rotate() if self.wal is not None else 0
        self._install_snapshot(gen, self._snapshot_state(seq), seq)

    def _install_snapshot(self, gen: int, state: dict, seq: int) -> None:
        """Write one captured snapshot and prune the WAL prefix it covers.
        The lock serializes the close path against an in-flight compaction
        executor write; the generation check drops a capture that lost the
        race — installing the older state after the newer prune would leave
        a snapshot whose missing mutations no segment holds anymore. Prune
        ONLY on a successful install: a failed snapshot write (ENOSPC, EIO)
        must keep the sealed segments, or the acknowledged mutations in
        them would vanish on the next restore."""
        with self._snap_lock:
            if gen <= self._snap_installed:
                return
            if self._write_snapshot_state(state):
                self._snap_installed = gen
                if self.wal is not None:
                    self.wal.prune(seq)

    def _write_snapshot_state(self, state: dict) -> bool:
        try:
            tmp = self.store_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, self.store_path)
            return True
        except OSError:
            logger.exception("GCS snapshot write failed")
            return False

    async def _compaction_loop(self):
        """Snapshot + WAL-truncate compaction (replaces the old lossy 1s
        snapshot loop, whose inter-tick mutations died with the process).
        Durability now comes from the WAL; this loop only bounds restart
        replay time and reclaims log space. With the WAL disabled the
        snapshot IS the durability plane again, so it keeps the historical
        1s cadence instead of the compaction interval."""
        snap_interval = (_config.gcs_snapshot_interval_s
                         if self.wal is not None else 1.0)
        last = time.monotonic()
        while True:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            over = (self.wal is not None
                    and self.wal.size() >= _config.gcs_wal_max_bytes)
            due = (self._store_dirty and now - last >= snap_interval)
            if not (over or due):
                continue
            last = now
            self._store_dirty = False
            # rotate + durable-table capture ON the loop (consistent
            # tables; records landing after the rotate carry higher seqs
            # and replay idempotently over this snapshot); the task-event
            # and timeseries copy-outs take their own locks and run OFF
            # the loop with the pickle + prune — the aggregator copy
            # grows with retained history and would stall heartbeat and
            # scheduling rpcs if done inline
            self._snap_gen += 1
            gen = self._snap_gen
            seq = self.wal.rotate() if self.wal is not None else 0
            state = self._snapshot_state(seq, include_heavy=False)

            def write():
                # slight skew vs the table capture is fine: both are
                # soft state, replaced wholesale on the next compaction
                self._snapshot_heavy(state)
                self._install_snapshot(gen, state, seq)

            await asyncio.get_event_loop().run_in_executor(None, write)
            if _config.metrics_enabled:
                from ray_tpu_torch.util.metrics import Counter

                Counter(
                    "gcs_wal_compactions_total",
                    "snapshot+truncate compactions of the GCS WAL",
                ).inc(1.0)

    def _restore_actor(self, aid: bytes, a: dict) -> None:
        """(Re)build a restored detached actor PENDING; idempotent — WAL
        replay over a snapshot-restored entry overwrites in place."""
        info = ActorInfo(
            actor_id=aid,
            spec_blob=a["spec_blob"],
            name=a["name"],
            namespace=a.get("namespace", "default"),
            detached=True,
            max_restarts=a["max_restarts"],
            restarts_left=a["restarts_left"],
            resources=a["resources"],
            pg_id=a["pg_id"],
            bundle_index=a["bundle_index"],
        )
        info.restore_node_hint = a.get("node_id")
        self.actors[aid] = info
        if info.name:
            self.named_actors[(info.namespace, info.name)] = aid

    def _restore_store(self) -> int:
        """Load the newest snapshot; returns the WAL sequence it covers
        (0 = no/unreadable snapshot: replay the whole log)."""
        try:
            with open(self.store_path, "rb") as f:
                state = pickle.load(f)
        except FileNotFoundError:
            return 0
        except Exception:  # noqa: BLE001 - corrupt snapshot: start fresh
            logger.exception("GCS snapshot restore failed; starting fresh")
            return 0
        return self._restore_from_state(state)

    def _restore_from_state(self, state: dict) -> int:
        self.kv = state.get("kv", {})
        self.functions = state.get("functions", {})
        self.job_counter = state.get("job_counter", 0)
        for pg_id, p in state.get("placement_groups", {}).items():
            self._apply_wal("pg_put", {"pg_id": pg_id, "entry": p})
        for aid, a in state.get("actors", {}).items():
            self._restore_actor(aid, a)
        self.named_actors.update(state.get("named_actors", {}))
        self.metrics.update(state.get("metrics", {}))
        self.metric_reports.update(state.get("metric_reports", {}))
        self.timeseries.restore(state.get("timeseries", ()))
        self.task_events.restore(state.get("task_events"))
        logger.info(
            "GCS restored: %d kv, %d fns, %d detached actors, "
            "%d timeseries samples",
            len(self.kv), len(self.functions), len(self.actors),
            len(self.timeseries),
        )
        return int(state.get("wal_seq", 0))

    def _schedule_restored(self) -> None:
        """Restored actors/PGs reschedule once nodes re-register (called
        after snapshot restore AND WAL replay, so a replayed actor_dead
        never races a stale reschedule)."""
        for info in list(self.actors.values()):
            if info.state != DEAD:
                self._call_later_held(1.0, self._retry_schedule, info)
        for pg in list(self.placement_groups.values()):
            self._call_later_held(1.0, self._retry_place_pg, pg)

    # ------------------------------------------------------------- pubsub
    async def publish(self, channel: str, payload):
        dead = []
        # snapshot: awaiting push suspends mid-iteration and a concurrent
        # (un)subscribe for the same channel would mutate the live set
        for conn in list(self.subscribers.get(channel, set())):
            try:
                await conn.push(channel, payload)
            except rpc.ConnectionLost:
                dead.append(conn)
        for c in dead:
            self.subscribers.get(channel, set()).discard(c)

    def handle_subscribe(self, conn, channels: List[str]):
        for ch in channels:
            self.subscribers.setdefault(ch, set()).add(conn)
        return True

    def handle_unsubscribe(self, conn, channels: List[str]):
        for ch in channels:
            subs = self.subscribers.get(ch)
            if subs is not None:
                subs.discard(conn)
                if not subs:
                    # drop the empty set: transient user channels (pubsub)
                    # would otherwise accumulate keys forever
                    del self.subscribers[ch]
        return True

    async def handle_publish(self, conn, channel: str, payload) -> int:
        """General pubsub publish from any cluster process (reference:
        src/ray/pubsub/ + gcs_pubsub.py). User channels arrive namespaced
        ("user:*" — util/pubsub.py) so they can't collide with the internal
        ones (logs, actor state); returns the subscriber count."""
        await self.publish(channel, payload)
        return len(self.subscribers.get(channel, ()))

    # -------------------------------------------------------------- nodes
    async def handle_register_node(
        self, conn, node_id, address, session, resources, labels=None,
        transfer_port=None,
    ):
        total = ResourceSet(resources)
        info = NodeInfo(
            node_id=node_id,
            address=address,
            session=session,
            total=total,
            available=total,
            labels=labels or {},
            conn=conn,
        )
        info.transfer_port = transfer_port  # native data-plane daemon
        self.nodes[node_id] = info
        conn.node_id = node_id
        await self.publish("node", {"event": "added", "node": self.nodes[node_id].public()})
        return {"node_id": node_id, "num_nodes": len(self.nodes)}

    def handle_resource_report(self, conn, node_id, available, pending=None):
        node = self.nodes.get(node_id)
        if node is None:
            return False
        node.available = ResourceSet(available)
        node.last_report = time.monotonic()
        if not node.alive:
            node.alive = True  # recovered
        return True

    def handle_get_nodes(self, conn):
        return [n.public() for n in self.nodes.values()]

    def handle_get_resource_view(self, conn):
        return {
            n.node_id: {
                "total": n.total.to_dict(),
                "available": n.available.to_dict(),
                "alive": n.alive,
                "address": n.address,
                "session": n.session,
                "transfer_port": getattr(n, "transfer_port", None),
            }
            for n in self.nodes.values()
        }

    async def _health_check_loop(self):
        period = _config.health_check_period_ms / 1000
        threshold = period * _config.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node in list(self.nodes.values()):
                if node.alive and now - node.last_report > threshold:
                    await self._on_node_dead(node, "missed health checks")

    async def _on_node_dead(self, node: NodeInfo, reason: str):
        node.alive = False
        logger.warning("node %s dead: %s", node.node_id, reason)
        # dead-node object recovery: a dead node serves no copies, so for
        # every object it held either promote a surviving holder's
        # SECONDARY to PRIMARY, or — when no in-memory copy survives but
        # the dead raylet registered spill metadata — hand its spill file
        # to a live raylet (same-host adoption). With neither, the entry
        # drops and the owner's get() falls back to lineage
        # reconstruction instead of hanging on a ghost holder.
        promote: Dict[str, list] = {}  # survivor node_id -> [oid_hex]
        orphans: list = []             # (oid_hex, spill metadata)
        for oid_hex in list(self.object_locations):
            holders = self.object_locations[oid_hex]
            dead = holders.pop(node.node_id, None)
            if not holders:
                self.object_locations.pop(oid_hex, None)
                self._object_loc_rr.pop(oid_hex, None)
            if dead is None:
                continue
            if holders:
                survivor = next(
                    (nid for nid in holders
                     if (n := self.nodes.get(nid)) is not None and n.alive),
                    None,
                )
                if survivor is not None:
                    promote.setdefault(survivor, []).append(oid_hex)
            elif isinstance(dead, dict) and dead.get("spill"):
                orphans.append((oid_hex, dead["spill"]))
        await self._reassign_object_copies(node, promote, orphans)
        await self.publish("node", {"event": "dead", "node_id": node.node_id})
        # fail over actors on that node
        for actor in list(self.actors.values()):
            if actor.node_id == node.node_id and actor.state in (ALIVE, PENDING):
                await self._on_actor_failure(actor, f"node {node.node_id} died")

    async def _reassign_object_copies(self, dead_node, promote: dict,
                                      orphans: list) -> None:
        """Execute the death-path object reassignments computed by
        _on_node_dead: promotion rpcs to surviving holders, and spill-file
        adoption by one live raylet (re-registered here on success)."""
        for nid, oids in promote.items():
            n = self.nodes.get(nid)
            if n is None or n.conn is None:
                continue
            try:
                await n.conn.call("promote_primary", oids_hex=oids,
                                  timeout=10)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass  # the copy still serves; promotion is advisory
        if not orphans:
            return
        adopter = next(
            (n for n in self.nodes.values()
             if n.alive and n.conn is not None
             and n.node_id != dead_node.node_id),
            None,
        )
        if adopter is None:
            return
        entries = [(oid_hex, sp.get("path"), sp.get("nbytes"), sp.get("crc"))
                   for oid_hex, sp in orphans]
        try:
            adopted = await adopter.conn.call("adopt_spill", entries=entries,
                                              timeout=30)
        except (rpc.RpcError, rpc.ConnectionLost):
            adopted = []
        adopted = set(adopted or [])
        for oid_hex, sp in orphans:
            if oid_hex in adopted:
                self.object_locations.setdefault(oid_hex, {})[
                    adopter.node_id
                ] = {"nbytes": int(sp.get("nbytes") or 0), "spill": dict(sp)}
        if adopted:
            logger.warning(
                "node %s died: %d spilled objects adopted by %s",
                dead_node.node_id, len(adopted), adopter.node_id,
            )

    # ------------------------------------------- object-location directory
    def handle_object_location_add(self, conn, oid_hex, node_id, nbytes):
        """A raylet completed a pull: record it as a secondary holder
        (spill metadata, if this holder spilled earlier, is preserved)."""
        slot = self.object_locations.setdefault(oid_hex, {}).setdefault(
            node_id, {"nbytes": 0, "spill": None}
        )
        slot["nbytes"] = int(nbytes)
        return True

    def handle_object_location_spill(self, conn, entries):
        """Batched spill-metadata registration: [(oid_hex, node_id, path,
        nbytes, crc)]. Recorded alongside the holder entry so the
        node-death path can hand the file to a surviving raylet on the
        host (the spill dir lives outside the dead process)."""
        for oid_hex, node_id, path, nbytes, crc in entries:
            slot = self.object_locations.setdefault(oid_hex, {}).setdefault(
                node_id, {"nbytes": int(nbytes), "spill": None}
            )
            slot["nbytes"] = int(nbytes)
            slot["spill"] = {"path": path, "nbytes": int(nbytes), "crc": crc}
        return True

    def handle_object_location_remove(self, conn, entries):
        """Batched deregistration: [(oid_hex, node_id)] whose local copy
        was evicted or freed."""
        for oid_hex, node_id in entries:
            holders = self.object_locations.get(oid_hex)
            if holders is None:
                continue
            holders.pop(node_id, None)
            if not holders:
                self.object_locations.pop(oid_hex, None)
                self._object_loc_rr.pop(oid_hex, None)
        return True

    def handle_object_locations(self, conn, oid_hex):
        """Alive registered holders of an object, as dial-ready dicts.
        The list is ROTATED one step per query (round-robin), so N pullers
        of one hot object spread across the holder set — the broadcast
        distribution tree — instead of all dialing the first holder."""
        holders = self.object_locations.get(oid_hex)
        if not holders:
            return []
        out = []
        for node_id, info in holders.items():
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                continue
            out.append({
                "node_id": node_id,
                "address": node.address,
                "session": node.session,
                "transfer_port": getattr(node, "transfer_port", None),
                "nbytes": info["nbytes"],
                "spilled": bool(info.get("spill")),
            })
        if len(out) > 1:
            rot = self._object_loc_rr.get(oid_hex, 0) % len(out)
            out = out[rot:] + out[:rot]
        self._object_loc_rr[oid_hex] = self._object_loc_rr.get(oid_hex, 0) + 1
        return out


    def handle_kv_put(self, conn, ns, key, value, overwrite=True):
        k = (ns, key)
        if not overwrite and k in self.kv:
            return False
        self.kv[k] = value
        self._append_wal("kv_put", ns=ns, key=key, value=value)
        self._store_dirty = True
        return True

    def handle_kv_get(self, conn, ns, key):
        return self.kv.get((ns, key))

    def handle_kv_del(self, conn, ns, key):
        self._store_dirty = True
        existed = self.kv.pop((ns, key), None) is not None
        if existed:
            self._append_wal("kv_del", ns=ns, key=key)
        return existed

    def handle_kv_keys(self, conn, ns, prefix=""):
        return [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]

    # ---------------------------------------------------------- functions
    def handle_register_function(self, conn, fn_id, blob):
        self.functions[fn_id] = blob
        self._append_wal("fn", fn_id=fn_id, blob=blob)
        self._store_dirty = True
        return True

    def handle_get_function(self, conn, fn_id):
        return self.functions.get(fn_id)

    # -------------------------------------------------------------- jobs
    def handle_register_driver(self, conn, metadata=None, job_id=None):
        """Mint a job id — or, with ``job_id``, RE-register a driver that
        reconnected to a restarted GCS: it keeps its identity (per-job
        task retention, job-tagged events stay one job) and the counter
        only moves forward so later fresh drivers never collide."""
        conn.is_driver = True
        if job_id is not None:
            self.job_counter = max(self.job_counter, int(job_id))
            self._append_wal("job", value=self.job_counter)
            self._store_dirty = True
            return {"job_id": int(job_id)}
        self.job_counter += 1
        self._append_wal("job", value=self.job_counter)
        self._store_dirty = True
        return {"job_id": self.job_counter}

    # ------------------------------------------------------------- actors
    async def handle_create_actor(
        self,
        conn,
        actor_id,
        spec_blob,
        name=None,
        namespace="default",
        detached=False,
        max_restarts=0,
        resources=None,
        get_if_exists=False,
        pg_id=None,
        bundle_index=-1,
    ):
        if name:
            key = (namespace, name)
            existing = self.named_actors.get(key)
            if existing is not None and self.actors[existing].state != DEAD:
                if get_if_exists:
                    return {"actor_id": existing, "existing": True}
                raise ValueError(f"actor name {name!r} already taken")
            self.named_actors[key] = actor_id
        info = ActorInfo(
            actor_id=actor_id,
            spec_blob=spec_blob,
            name=name,
            namespace=namespace,
            detached=detached,
            owner_conn=None if detached else conn,
            max_restarts=max_restarts,
            restarts_left=max_restarts,
            resources=resources or {},
            pg_id=pg_id,
            bundle_index=bundle_index,
        )
        self.actors[actor_id] = info
        self._store_dirty = True
        if detached:
            # durable before the creation rpc is acknowledged: a detached
            # actor the caller believes exists must survive a head crash
            self._append_wal(
                "actor_put", aid=actor_id, entry=self._actor_entry(info)
            )
        if not detached:
            self._conn_owned_actors.setdefault(conn, set()).add(actor_id)
        await self._schedule_actor(info)
        return {"actor_id": actor_id, "existing": False}

    async def _schedule_actor(self, info: ActorInfo):
        demand = ResourceSet(info.resources)
        if info.pg_id is not None:
            # PG actor: its node is dictated by the bundle placement, and its
            # resources come from the bundle reservation — never deduct from
            # the node view (the bundle already did; double-booking starved
            # plain tasks, round-3 fix).
            pg = self.placement_groups.get(info.pg_id)
            if pg is None:
                # its PG was removed (actors reference PGs that exist at
                # creation): without this the actor reschedules every 0.5s
                # forever while callers burn wait_alive timeouts
                await self._mark_actor_dead(
                    info, "placement group removed before actor scheduled"
                )
                return
            if not pg.placement:
                self._call_later_held(0.5, self._retry_schedule, info)
                return
            if info.bundle_index >= 0:
                idx = info.bundle_index
            else:
                # unspecified bundle: rotate across bundle nodes on each
                # attempt — pinning to bundle 0's node starved actors when
                # that node's bundles were full but another node's were free
                # (the raylet can only draw from its OWN bundles)
                idx = info.sched_attempts % len(pg.placement)
            info.sched_attempts += 1
            node_id = pg.placement[idx]
        else:
            hint = getattr(info, "restore_node_hint", None)
            if hint is not None:
                # store-restored actor: its worker may still be LIVE on the
                # node it ran on — route there first so the raylet adopts it
                # instead of a fresh instance spawning elsewhere. One shot:
                # fall back to the policy if the node never comes back.
                if hint in self.nodes and self.nodes[hint].alive:
                    info.restore_node_hint = None
                    node_id = hint
                elif info.sched_attempts < 20:
                    info.sched_attempts += 1
                    self._call_later_held(0.5, self._retry_schedule, info)
                    return
                else:
                    info.restore_node_hint = None
                    node_id = None
            else:
                node_id = None
            if node_id is None:
                views = [n.view() for n in self.nodes.values()]
                node_id = hybrid_policy(
                    demand,
                    views,
                    spread_threshold=_config.scheduler_spread_threshold,
                    top_k_fraction=_config.scheduler_top_k_fraction,
                )
        if node_id is None or node_id not in self.nodes:
            # queue until resources free up: retry on next resource report
            self._call_later_held(0.5, self._retry_schedule, info)
            return
        node = self.nodes[node_id]
        info.node_id = node_id
        if info.pg_id is None:
            # optimistic deduction so back-to-back placements don't
            # double-book the node before its next resource report
            node.available = node.available.subtract(demand)
        try:
            await node.conn.call(
                "create_actor_worker",
                actor_id=info.actor_id,
                spec_blob=info.spec_blob,
                resources=info.resources,
                pg_id=info.pg_id,
                bundle_index=info.bundle_index,
                timeout=_config.gcs_rpc_timeout_s,
            )
        except (rpc.RpcError, rpc.ConnectionLost):
            # stale view or raylet race — requeue, do NOT burn a restart
            if info.pg_id is None:
                node.available = node.available.add(demand)
            info.node_id = None
            self._call_later_held(0.5, self._retry_schedule, info)

    def _call_later_held(self, delay: float, coro_fn, *args) -> None:
        """Run ``coro_fn(*args)`` as a task after ``delay``, holding a
        strong ref until it finishes. The scheduling/retry paths all
        funnel through here: a dropped retry task means an actor or PG
        that silently never places."""
        def _spawn():
            t = asyncio.ensure_future(coro_fn(*args))
            self._held_tasks.add(t)
            t.add_done_callback(self._held_tasks.discard)

        asyncio.get_running_loop().call_later(delay, _spawn)

    async def _retry_schedule(self, info: ActorInfo):
        if info.state in (PENDING, RESTARTING):
            await self._schedule_actor(info)

    async def handle_actor_ready(self, conn, actor_id, address, node_id):
        info = self.actors.get(actor_id)
        if info is None:
            return False
        self._store_dirty = True
        info.state = ALIVE
        info.address = address
        info.node_id = node_id
        if info.detached:
            # refresh the durable adoption hint (node placement +
            # remaining restart budget) now that the actor is live here
            self._append_wal(
                "actor_put", aid=actor_id, entry=self._actor_entry(info)
            )
        self._signal_actor_state(actor_id)
        await self.publish("actor", info.public())
        return True

    async def handle_actor_failed(self, conn, actor_id, reason):
        info = self.actors.get(actor_id)
        if info and info.state != DEAD:
            await self._on_actor_failure(info, reason)
        return True

    async def _on_actor_failure(self, info: ActorInfo, reason: str):
        if info.restarts_left != 0 and info.state != DEAD:
            if info.restarts_left > 0:
                info.restarts_left -= 1
            info.num_restarts += 1
            info.state = RESTARTING
            info.address = None
            await self.publish("actor", info.public())
            await asyncio.sleep(_config.actor_restart_backoff_s)
            await self._schedule_actor(info)
        else:
            await self._mark_actor_dead(info, reason)

    async def _mark_actor_dead(self, info: ActorInfo, reason: str):
        self._store_dirty = True
        if info.detached:
            self._append_wal("actor_dead", aid=info.actor_id)
        info.state = DEAD
        self._signal_actor_state(info.actor_id)
        info.death_reason = reason
        info.address = None
        if info.name and self.named_actors.get((info.namespace, info.name)) == info.actor_id:
            del self.named_actors[(info.namespace, info.name)]
        await self.publish("actor", info.public())

    def _actor_event(self, actor_id: bytes) -> asyncio.Event:
        ev = self._actor_events.get(actor_id)
        if ev is None:
            ev = self._actor_events.setdefault(actor_id, asyncio.Event())
        return ev

    def _signal_actor_state(self, actor_id: bytes) -> None:
        ev = self._actor_events.pop(actor_id, None)
        if ev is not None:
            ev.set()

    async def handle_get_actor(self, conn, actor_id, wait_alive=False,
                               wait_timeout=30.0):
        info = self.actors.get(actor_id)
        if info is None:
            return None
        # event-driven wait (no 20ms polling tick per caller — the reference
        # pushes actor state via pubsub; weak-#4 fix): state transitions
        # signal the per-actor event
        deadline = time.monotonic() + wait_timeout
        while wait_alive and info.state in (PENDING, RESTARTING):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                await asyncio.wait_for(
                    self._actor_event(actor_id).wait(), timeout=remaining
                )
            except asyncio.TimeoutError:
                break
        return info.public()

    def handle_get_named_actor(self, conn, name, namespace="default"):
        actor_id = self.named_actors.get((namespace, name))
        if actor_id is None:
            return None
        return self.actors[actor_id].public()

    # ------------------------------------------------------- observability
    def handle_report_task_events(self, conn, events: List[dict],
                                  dropped: int = 0, source: str = None):
        """Workers/drivers/raylets flush buffered task state transitions
        here (task_event_buffer.h:193 → GcsTaskManager). ``dropped`` is the
        source's CUMULATIVE drop counter (bounded-buffer overflow + flush
        failures), surfaced through metrics and get_task."""
        self.task_events.ingest(events, dropped=dropped, source=source)
        for e in events:
            state = e.get("state", "UNKNOWN")
            if state == "PROFILE":
                continue
            key = f"tasks_{state.lower()}"
            self.metrics[key] = self.metrics.get(key, 0) + 1
        return True

    def handle_list_tasks(self, conn, limit=1000):
        """One row per task: latest state, ids hex-normalized."""
        return self.task_events.list_tasks(limit)

    def handle_get_task(self, conn, task_id: str):
        """Full event timeline of one task (state-API get_task)."""
        return self.task_events.get_task(task_id)

    def handle_summarize_tasks(self, conn):
        return self.task_events.summarize()

    def handle_timeline_events(self, conn, limit=50_000):
        """Flat event list backing ray_tpu_torch.timeline()'s Chrome-trace export."""
        return self.task_events.timeline_events(limit)

    def handle_list_placement_groups(self, conn):
        return [
            {
                "pg_id": info.pg_id,
                "state": info.state,
                "bundles": info.bundles,
                "strategy": info.strategy,
                "placement": info.placement,
            }
            for info in self.placement_groups.values()
        ]

    def handle_get_metrics(self, conn):
        m = dict(self.metrics)
        m.update(self.task_events.stats())  # tracing drop/retention counters
        # the GCS's own wire counters, namespaced so they don't collide with
        # the caller's (util/state.summarize_metrics merges the driver's
        # un-prefixed rpc_* counters on top of this reply)
        for k, v in rpc.stats_snapshot().items():
            m["gcs_" + k] = v
        m["num_nodes"] = len(self.nodes)
        m["num_alive_nodes"] = sum(1 for n in self.nodes.values() if n.alive)
        m["num_actors"] = len(self.actors)
        m["num_alive_actors"] = sum(
            1 for a in self.actors.values() if a.state == ALIVE
        )
        m["num_placement_groups"] = len(self.placement_groups)
        return m

    def handle_report_metrics(self, conn, source: str, samples: list):
        """A process flushed its metrics registry (util/metrics.py)."""
        self.metric_reports[source] = (time.time(), samples)
        return True

    def _merged_metrics(self) -> list:
        """Cluster-wide merge: every reported registry + the GCS's own
        synthetic counters/gauges + the GCS process's own metrics registry
        (the task-duration histograms the aggregator derives live there)."""
        from ray_tpu_torch.util.metrics import get_registry, merge_snapshots

        gcs_series = [
            {
                "name": "gcs_" + k, "kind": "counter", "description": "",
                "boundaries": [], "points": {(): float(v)},
            }
            for k, v in self.metrics.items()
        ]
        gauges = {
            "gcs_alive_nodes": sum(1 for n in self.nodes.values() if n.alive),
            "gcs_alive_actors": sum(
                1 for a in self.actors.values() if a.state == ALIVE
            ),
            "gcs_placement_groups": len(self.placement_groups),
        }
        gcs_series += [
            {
                "name": k, "kind": "gauge", "description": "",
                "boundaries": [], "points": {(): float(v)},
            }
            for k, v in gauges.items()
        ]
        now = time.time()
        return merge_snapshots({
            **self.metric_reports,
            "gcs": (now, gcs_series),
            "gcs-process": (now, get_registry().collect()),
        })

    def handle_collect_metrics(self, conn):
        """Cluster-wide merged user+core metrics, for the dashboard's
        /metrics endpoint."""
        return self._merged_metrics()

    def handle_get_metrics_timeseries(self, conn, names=None, limit=None):
        """Bounded history of merged snapshots (one every
        metrics_report_interval_ms): [{"ts", "series"}...], newest last."""
        return self.timeseries.query(names=names, limit=limit)

    async def _metrics_sample_loop(self):
        """Sample the cluster-wide merge into the bounded time-series ring
        (the retention layer behind get_metrics_timeseries)."""
        from ray_tpu_torch.core import rpc as rpc_mod

        period = max(_config.metrics_report_interval_ms, 100) / 1000
        while True:
            await asyncio.sleep(period)
            try:
                rpc_mod.publish_wire_counters()
                self.timeseries.sample(self._merged_metrics())
            except Exception:  # noqa: BLE001 - sampling must never kill GCS
                logger.exception("metrics sample loop error")

    async def handle_publish_logs(self, conn, batch: dict):
        """A raylet's log monitor pushed a batch of worker log lines; fan
        them out to every "logs" subscriber (drivers)."""
        await self.publish("logs", batch)

    def handle_list_actors(self, conn):
        return [a.public() for a in self.actors.values()]

    async def handle_kill_actor(self, conn, actor_id, no_restart=True):
        info = self.actors.get(actor_id)
        if info is None:
            return False
        if no_restart:
            info.restarts_left = 0
        node = self.nodes.get(info.node_id) if info.node_id else None
        if node and node.alive and info.address:
            try:
                await node.conn.call("kill_actor_worker", actor_id=actor_id, timeout=5)
            except (rpc.RpcError, rpc.ConnectionLost):
                pass
        if no_restart:
            await self._mark_actor_dead(info, "killed via ray_tpu_torch.kill")
        return True

    # --------------------------------------------------- placement groups
    async def handle_create_placement_group(
        self, conn, pg_id, bundles, strategy, detached=False, create_timeout=30.0
    ):
        info = PlacementGroupInfo(
            pg_id=pg_id,
            bundles=bundles,
            strategy=strategy,
            creator_conn=conn,
            detached=detached,
        )
        self.placement_groups[pg_id] = info
        self._store_dirty = True
        if detached:
            self._append_wal("pg_put", pg_id=pg_id, entry={
                "bundles": bundles, "strategy": strategy, "placement": None,
            })
        if not detached:
            self._conn_owned_pgs.setdefault(conn, set()).add(pg_id)
        deadline = time.monotonic() + create_timeout
        while time.monotonic() < deadline:
            placed = await self._try_place_pg(info)
            if placed:
                return {"state": "CREATED", "placement": info.placement}
            await asyncio.sleep(0.1)
        return {"state": "PENDING", "placement": None}

    async def _retry_place_pg(self, info: PlacementGroupInfo, attempts: int = 0):
        """Keep trying to place a restored (detached) PG as nodes register.

        A restored placement is RE-ADOPTED: the original nodes still hold the
        bundle reservations (reserve_bundle is idempotent), so we re-confirm
        on those exact nodes. If a placement node never re-registers, fall
        back to placing fresh."""
        if info.pg_id not in self.placement_groups:
            return
        if info.placement:
            missing = [n for n in info.placement if n not in self.nodes
                       or not self.nodes[n].alive]
            if not missing:
                ok = True
                for idx, node_id in enumerate(info.placement):
                    try:
                        ok = ok and await self.nodes[node_id].conn.call(
                            "reserve_bundle", pg_id=info.pg_id,
                            bundle_index=idx, resources=info.bundles[idx],
                            timeout=10,
                        )
                    except (rpc.RpcError, rpc.ConnectionLost):
                        ok = False
                if ok:
                    info.state = "CREATED"
                    return
            if attempts < 30:
                self._call_later_held(1.0, self._retry_place_pg, info,
                                      attempts + 1)
                return
            info.placement = None  # original nodes gone: place fresh
            info.state = "PENDING"
        if not await self._try_place_pg(info):
            self._call_later_held(1.0, self._retry_place_pg, info,
                                  attempts + 1)

    async def _try_place_pg(self, info: PlacementGroupInfo) -> bool:
        views = [n.view() for n in self.nodes.values()]
        demands = [ResourceSet(b) for b in info.bundles]
        placement = pack_bundles(demands, views, info.strategy)
        if placement is None:
            return False
        # reserve on each node; roll back on partial failure
        reserved = []
        for idx, node_id in enumerate(placement):
            node = self.nodes[node_id]
            try:
                ok = await node.conn.call(
                    "reserve_bundle",
                    pg_id=info.pg_id,
                    bundle_index=idx,
                    resources=info.bundles[idx],
                    timeout=10,
                )
            except (rpc.RpcError, rpc.ConnectionLost):
                ok = False
            if not ok:
                for ridx, rnode_id in reserved:
                    rnode = self.nodes.get(rnode_id)
                    if rnode and rnode.alive:
                        try:
                            await rnode.conn.call(
                                "release_bundle", pg_id=info.pg_id,
                                bundle_index=ridx, timeout=10,
                            )
                        except (rpc.RpcError, rpc.ConnectionLost):
                            pass
                return False
            reserved.append((idx, node_id))
        info.placement = placement
        info.state = "CREATED"
        self._store_dirty = True
        if info.detached:
            self._append_wal("pg_put", pg_id=info.pg_id, entry={
                "bundles": info.bundles, "strategy": info.strategy,
                "placement": placement,
            })
        await self.publish("pg", {"pg_id": info.pg_id, "state": "CREATED"})
        return True

    async def handle_remove_placement_group(self, conn, pg_id):
        self._store_dirty = True
        info = self.placement_groups.pop(pg_id, None)
        if info is None:
            return False
        if info.detached:
            self._append_wal("pg_del", pg_id=pg_id)
        if info.placement:
            for idx, node_id in enumerate(info.placement):
                node = self.nodes.get(node_id)
                if node and node.alive:
                    try:
                        await node.conn.call(
                            "release_bundle", pg_id=pg_id, bundle_index=idx,
                            timeout=10,
                        )
                    except (rpc.RpcError, rpc.ConnectionLost):
                        pass
        return True

    def handle_get_placement_group(self, conn, pg_id):
        info = self.placement_groups.get(pg_id)
        if info is None:
            return None
        return {
            "pg_id": info.pg_id,
            "state": info.state,
            "placement": info.placement,
            "bundles": info.bundles,
            "strategy": info.strategy,
        }

    # --------------------------------------------------------- disconnects
    async def on_disconnection(self, conn):
        # driver gone → tear down its non-detached actors and PGs
        for actor_id in self._conn_owned_actors.pop(conn, set()):
            info = self.actors.get(actor_id)
            if info and info.state != DEAD:
                info.restarts_left = 0
                await self.handle_kill_actor(conn, actor_id, no_restart=True)
        for pg_id in self._conn_owned_pgs.pop(conn, set()):
            await self.handle_remove_placement_group(conn, pg_id)
        # raylet connection drop → node dead (faster than health check timeout)
        node_id = getattr(conn, "node_id", None)
        if node_id and node_id in self.nodes:
            node = self.nodes[node_id]
            if node.alive and node.conn is conn:
                await self._on_node_dead(node, "connection lost")


def main():
    """GCS process entrypoint: ray_tpu_torch-gcs --port N"""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--store", default=None,
                        help="snapshot file for GCS fault tolerance")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    async def run():
        gcs = GcsServer(host=args.host, port=args.port, store_path=args.store)
        addr = await gcs.start()
        print(f"GCS_ADDRESS={addr}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()

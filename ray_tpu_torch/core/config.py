"""Runtime configuration flags.

The port's copy of ray_tpu/core/config.py, cut to the fields the ported
modules read (names and defaults the reference's): every tunable lives in
this table, overridable via ``RAY_TPU_<NAME>`` environment variables,
readable as ``ray_tpu_torch._config.<name>``. The other planes' fields
(serve, chaos, autoscaling, the GCS's shipped task-event WAL tails) come
with those planes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields


def _env(name: str, default):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    return raw


@dataclass
class Config:
    # --- scheduling ---------------------------------------------------------
    # Hybrid scheduling: prefer the local node until its utilization crosses
    # this threshold, then pack (hybrid_scheduling_policy.h)
    scheduler_spread_threshold: float = 0.5
    scheduler_top_k_fraction: float = 0.2
    max_pending_lease_requests_per_scheduling_key: int = 10
    worker_lease_timeout_ms: int = 10_000
    # owner-side lease caching: an idle cached lease returns to its raylet
    # after this long without a task
    worker_lease_idle_ttl_ms: int = 500
    # locality-aware lease scheduling: lease requests carry per-arg
    # (oid, nbytes, node) hints, and a raylet choosing between feasible
    # nodes subtracts locality_weight * (resident hinted bytes / total
    # hinted bytes) from each candidate's utilization score. 0 disables
    # locality (hints still ride the wire).
    locality_weight: float = 0.5
    # pipelined submission: up to this many of one owner's tasks can share
    # one leased worker, overlapping the wire round trip of task N+1 with
    # the worker-side execution of task N. Execution stays one at a time
    # through the worker's run slot; a task blocked in get() (or a stream
    # wait) hands its slot to the next queued task, so tasks that get tasks
    # make progress. Tasks that block outside get() are covered by work
    # stealing (worker_stealing_enabled).
    worker_max_tasks_in_flight: int = 10
    # bounded commitment for pipelined pushes: a pushed task that cannot
    # START within this window bounces back ({"requeue": True}) and the
    # owner resubmits it to another worker: the fallback bound behind work
    # stealing, for when no worker is idle
    worker_requeue_after_ms: int = 200
    # work stealing: when a leased worker goes fully idle, the owner asks
    # its most-loaded leased worker of the same scheduling key to give back
    # queued, never-started specs, which resubmit to the idle worker at
    # once instead of waiting out worker_requeue_after_ms
    worker_stealing_enabled: bool = True

    # --- object store -------------------------------------------------------
    object_store_memory_mb: int = 2048
    # objects smaller than this are returned in-band to the owner's memory
    # store instead of the shared-memory store (direct returns)
    max_direct_call_object_size: int = 100 * 1024
    object_spilling_dir: str = ""
    # proactive spill of cold PRIMARY copies past this fraction of capacity
    object_spill_threshold_frac: float = 0.8
    object_spill_interval_s: float = 1.0
    # owner pin leases on the primaries it owns (renewed every interval)
    object_pin_ttl_s: float = 30.0
    object_pin_renew_interval_s: float = 5.0

    # --- object plane: pull-based transfer (object_store/pull_manager.py) ---
    # chunked pulls over the stream transport: big objects cross nodes as
    # pull_chunk_bytes chunks landing straight into a building shm buffer,
    # resumable from the missing chunks after a severed stream; False
    # leaves the native-daemon and rpc rungs
    pull_chunked_enabled: bool = True
    pull_chunk_bytes: int = 4 * 1024 * 1024
    # credits per chunk stream (max unacked chunks in flight per source)
    pull_chunk_window: int = 8
    # objects at least this large with more than one holder stripe disjoint
    # chunk ranges across sources
    pull_stripe_min_bytes: int = 16 * 1024 * 1024
    # max concurrent sources one pull stripes across
    pull_max_stripe: int = 2
    # bytes of concurrently executing pulls on one raylet; excess pulls
    # queue (task-arg pulls ahead of prefetches)
    pull_max_inflight_bytes: int = 256 * 1024 * 1024
    # size-scaled transfer deadline: base + nbytes/1GiB * per_gb seconds
    object_transfer_timeout_base_s: float = 60.0
    object_transfer_timeout_per_gb_s: float = 60.0
    # a raylet starts pulling a queued lease's remote args (from its
    # locality hints) while the lease waits for a worker
    arg_prefetch_enabled: bool = True

    # --- rpc wire path (core/rpc.py) ----------------------------------------
    rpc_max_coalesce_bytes: int = 256 * 1024
    rpc_coalesce_delay_ms: float = 0.0
    rpc_adaptive_coalesce: bool = True
    rpc_adaptive_coalesce_max_ms: float = 0.5
    rpc_adaptive_coalesce_min_frames: float = 6.0
    # _send blocks once this many un-flushed bytes are queued on a connection
    rpc_max_outstanding_bytes: int = 64 * 1024 * 1024
    # buffers at least this large ride the frame's out-of-band segment table
    rpc_oob_threshold_bytes: int = 64 * 1024
    # owner-side metadata batches flush after at most this long
    rpc_batch_flush_ms: float = 2.0

    # --- stream transport (core/transport/) ----------------------------------
    # host a process's stream listener binds and advertises
    transport_bind_host: str = "127.0.0.1"
    # host peers dial; empty = the bind host (or the raylet's host when
    # binding 0.0.0.0)
    transport_advertise_host: str = ""
    # TCP connect and handshake bound of a stream writer
    transport_connect_timeout_s: float = 30.0
    # bound on one blocking socket send or recv: a peer stalled longer
    # severs the stream (typed error, never a silent hang)
    transport_io_timeout_s: float = 120.0

    # --- head-plane durability (GCS snapshot + WAL, core/gcs/) -------------
    gcs_wal_enabled: bool = True
    gcs_wal_fsync: bool = False
    gcs_wal_max_bytes: int = 8 * 1024 * 1024
    gcs_snapshot_interval_s: float = 15.0
    gcs_close_snapshot_timeout_s: float = 10.0

    # --- deadline clock-skew guard ------------------------------------------
    # absolute deadlines are wall-clock epoch seconds minted by the owner;
    # a receiving host whose clock disagrees with the owner's by more than
    # this (estimated from the spec's minted (wall, mono) pair) re-anchors
    # the remaining budget to its own clock instead of falsely shedding
    # (task_spec.effective_deadline)
    deadline_skew_tolerance_s: float = 5.0

    # --- timeouts / health --------------------------------------------------
    health_check_period_ms: int = 1_000
    health_check_failure_threshold: int = 5
    gcs_rpc_timeout_s: float = 30.0
    actor_restart_backoff_s: float = 0.5
    # max pipelined in-flight calls per actor
    actor_max_inflight_calls: int = 64

    # --- workers ------------------------------------------------------------
    num_workers_soft_limit: int = 0  # 0 = num_cpus
    worker_startup_timeout_s: float = 30.0
    enable_worker_prestart: bool = True

    # --- retries ------------------------------------------------------------
    task_max_retries: int = 3
    actor_max_restarts: int = 0
    # exponential backoff between task retries (retry_exceptions): delay(n) =
    # min(max, base * multiplier^(n-1)) * (1 ± jitter) (util/backoff.py)
    retry_backoff_base_ms: float = 50.0
    retry_backoff_max_ms: float = 5_000.0
    retry_backoff_multiplier: float = 2.0
    retry_backoff_jitter: float = 0.5
    # train: per-round driver wait on worker polls before probing liveness
    train_poll_timeout_s: float = 120.0

    # --- logging / events ---------------------------------------------------
    log_to_driver: bool = True
    # tracing (ray_tpu_torch/tracing/): master switch for task-event recording
    task_events_enabled: bool = True
    # deterministic trace/task sampling in [0, 1]: whole traces keep or drop
    # together (hash of the trace/task id), never half-recorded requests
    task_events_sample_rate: float = 1.0
    # per-process bounded buffer; overflow drops (and counts) instead of
    # blocking the hot path
    task_events_buffer_size: int = 10_000
    task_events_flush_interval_ms: int = 1_000
    # GCS-side retention: max tasks kept in the aggregator (oldest evicted)
    task_events_max_tasks: int = 10_000
    # per-job retention: a chatty job evicts its own oldest tasks before it
    # can push another job's history out of the aggregator
    task_events_max_tasks_per_job: int = 5_000
    # crash forensics: workers append each recorded event to a per-worker
    # WAL file in the session dir before the periodic flush; the raylet
    # recovers a SIGKILLed worker's orphaned WAL into the aggregator so the
    # final second of spans still closes its timeline
    task_events_wal_enabled: bool = True
    metrics_report_interval_ms: int = 2_000
    # master switch for the built-in hot-path instrumentation (raylet
    # lease-grant latency, task latency, streaming series); user-defined
    # metrics are unaffected
    metrics_enabled: bool = True
    # how many merged snapshots the GCS (and local backend) keep as the
    # metrics time series, sampled every metrics_report_interval_ms
    # (240 x 2s = 8 minutes of history by default)
    metrics_timeseries_depth: int = 240

    # --- dev-mode runtime sanitizers (RAY_TPU_SANITIZE=1, analysis/) -------
    # io-loop watchdog: a loop that fails to run a scheduled heartbeat for
    # this long is recorded as a stall violation (a blocking call is
    # squatting the loop)
    sanitize_loop_stall_s: float = 5.0
    # how often the watchdog pings each registered EventLoopThread
    sanitize_loop_ping_interval_s: float = 1.0

    def __post_init__(self):
        for f in fields(self):
            object.__setattr__(self, f.name, _env(f.name, getattr(self, f.name)))

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @staticmethod
    def from_json(s: str) -> "Config":
        cfg = Config()
        for k, v in json.loads(s).items():
            setattr(cfg, k, v)
        return cfg


_config = Config()

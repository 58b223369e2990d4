"""State API: list/get cluster entities.

Parity: python/ray/util/state/api.py:109 (`StateApiClient`, list_actors :782,
list_tasks :1009, list_nodes, list_objects, list_placement_groups) — backed
by the GCS (node/actor/PG tables, task-event log) and per-raylet object
directories.

The port's copy of ray_tpu/util/state.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _gcs_call(method: str, **kwargs):
    from ray_tpu_torch.api import _auto_init, _global_worker

    _auto_init()
    backend = _global_worker().backend
    core = getattr(backend, "core", None)
    if core is None:  # local mode: synthesize from the backend
        return backend.state_call(method, **kwargs)
    return core.io.run(core.gcs.call(method, timeout=30, **kwargs))


def list_nodes() -> List[Dict[str, Any]]:
    return _gcs_call("get_nodes")


def list_actors() -> List[Dict[str, Any]]:
    out = []
    for a in _gcs_call("list_actors"):
        a = dict(a)
        if isinstance(a.get("actor_id"), bytes):
            a["actor_id"] = a["actor_id"].hex()
        out.append(a)
    return out


def _hex_ids(row: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize id fields to hex strings (list_actors already hexes;
    task rows must match — no raw bytes escape the state API)."""
    out = dict(row)
    for k in ("task_id", "actor_id", "pg_id"):
        if isinstance(out.get(k), bytes):
            out[k] = out[k].hex()
    return out


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    """One row per task (latest state), ids hex-normalized."""
    return [_hex_ids(t) for t in _gcs_call("list_tasks", limit=limit)]


def get_task(task_id: str) -> Optional[Dict[str, Any]]:
    """Full event timeline of one task from the tracing aggregator
    (ray_tpu_torch/tracing/): lifecycle transitions + profile spans, latest
    state (terminal-sticky), and the sources' drop counter."""
    if isinstance(task_id, bytes):
        task_id = task_id.hex()
    info = _gcs_call("get_task", task_id=task_id)
    return _hex_ids(info) if info else None


def summarize_tasks() -> Dict[str, Any]:
    """Task counts by function name and state, plus tracing drop/retention
    counters (state-API summarize_tasks analog)."""
    return _gcs_call("summarize_tasks")


def timeline_events(limit: int = 50_000) -> List[Dict[str, Any]]:
    """Flat task-event list backing ray_tpu_torch.timeline()."""
    return _gcs_call("timeline_events", limit=limit)


def list_placement_groups() -> List[Dict[str, Any]]:
    out = []
    for pg in _gcs_call("list_placement_groups"):
        pg = dict(pg)
        if isinstance(pg.get("pg_id"), bytes):
            pg["pg_id"] = pg["pg_id"].hex()
        out.append(pg)
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Per-node object-store stats (num objects, bytes, spilled)."""
    from ray_tpu_torch.api import _auto_init, _global_worker

    _auto_init()
    backend = _global_worker().backend
    core = getattr(backend, "core", None)
    if core is None:
        return backend.state_call("object_stats")
    nodes = list_nodes()
    out = []
    for n in nodes:
        if not n.get("Alive"):
            continue
        try:
            async def q(addr=n["NodeManagerAddress"]):
                conn = await core._conn_to(addr, kind="raylet")
                if conn is None:
                    return None
                return await conn.call("object_stats", timeout=10)

            stats = core.io.run(q())
            if stats is not None:
                out.append({"node_id": n["NodeID"], **stats})
        except Exception:  # noqa: BLE001 - node racing shutdown
            pass
    return out


def summarize_metrics() -> Dict[str, Any]:
    """Cluster-level counters (nodes, actors, task states), plus this
    process's RPC wire counters (`rpc_frames_sent`, `rpc_bytes_sent`,
    `rpc_frames_coalesced`, `rpc_oob_bytes`, ...). The same rpc_* names are
    ALSO registered as real registry Counters in every process's metrics
    flush loop, so the cluster-wide sums live in `/metrics` and
    `get_metrics_timeseries`; this merge keeps the calling driver's own
    totals visible even before its first flush."""
    from ray_tpu_torch.analysis import sanitizers
    from ray_tpu_torch.core import rpc

    m = _gcs_call("get_metrics")
    if isinstance(m, dict):
        m.update(rpc.stats_snapshot())
        # dev-mode sanitizer trips: this process's own counts are always
        # visible here (like the rpc_* totals); cluster-wide sums ride the
        # sanitizer_violations_total registry Counter through the normal
        # metrics flush loops
        counts = sanitizers.violation_counts()
        if counts:
            m["sanitizer_violations"] = counts
    return m


# ------------------------------------------------------- metrics time series
def get_metrics_timeseries(names: Optional[List[str]] = None,
                           limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Bounded history of cluster-wide merged metric snapshots, one sample
    per ``metrics_report_interval_ms`` (``[{"ts", "series"}...]``, newest
    last). Backed by the GCS ring in cluster mode and an in-process ring in
    local mode — the retention layer behind "what was p99 five minutes
    ago"."""
    return _gcs_call("get_metrics_timeseries", names=names, limit=limit)


def metric_rate(name: str, tags: Optional[Dict[str, str]] = None,
                samples: Optional[List[dict]] = None,
                window: Optional[int] = None) -> Optional[float]:
    """Per-second rate of a cumulative Counter over the sampled window
    (e.g. serve QPS from ``serve_requests_total``)."""
    from ray_tpu_torch.util.metrics import counter_rate

    if samples is None:
        samples = get_metrics_timeseries(names=[name], limit=window)
    return counter_rate(samples, name, tags)


def metric_percentile(name: str, q: float,
                      tags: Optional[Dict[str, str]] = None,
                      samples: Optional[List[dict]] = None,
                      window: Optional[int] = None) -> Optional[float]:
    """q-th percentile (q in [0,1]) of a Histogram over the sampled window
    (bucket deltas first→last sample; e.g. p99 serve latency from
    ``serve_request_latency_ms``)."""
    from ray_tpu_torch.util.metrics import window_percentile

    if samples is None:
        samples = get_metrics_timeseries(names=[name], limit=window)
    return window_percentile(samples, name, q, tags)

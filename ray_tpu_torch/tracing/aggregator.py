"""GCS-side task-event aggregation with bounded retention.

Parity: src/ray/gcs/gcs_server/gcs_task_manager.h — per-task event storage
with a global task cap (oldest-finished evicted first), per-task event caps,
and drop counters surfaced as metrics. The same class backs local mode
(the LocalBackend owns one and drains the process buffer into it on query).

The port's copy of ray_tpu/tracing/aggregator.py.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.config import _config
from ray_tpu_torch.tracing import events as ev


def _terminal_state(states: List[str]) -> Optional[str]:
    # terminal verdicts are sticky: a RUNNING that flushes late (independent
    # 1s flush loops in owner and worker) must never resurrect a task
    if ev.FAILED in states:
        return ev.FAILED
    if ev.FINISHED in states:
        return ev.FINISHED
    return None


_task_hists = None


def _observe_task_duration(rec: dict, e: dict) -> None:
    """Core task latency series, DERIVED at the aggregator from the
    lifecycle events already flowing here — zero additional hot-path cost.
    e2e (SUBMITTED -> terminal) pairs owner-side events, exec (RUNNING ->
    EXECUTED) pairs worker-side events, so each delta stays on one process's
    clock and is immune to cross-host skew."""
    from ray_tpu_torch.core.config import _config

    if not _config.metrics_enabled:
        return
    global _task_hists
    if _task_hists is None:
        from ray_tpu_torch.util import metrics as m

        bounds = [1, 2, 5, 10, 25, 50, 100, 250, 500,
                  1000, 2500, 5000, 10000, 30000, 60000]
        _task_hists = (
            m.Histogram("task_e2e_ms",
                        "task submit -> terminal state (owner clock)",
                        boundaries=bounds, tag_keys=("name",)),
            m.Histogram("task_exec_ms",
                        "task execution RUNNING -> EXECUTED (worker clock)",
                        boundaries=bounds, tag_keys=("name",)),
        )
    e2e_hist, exec_hist = _task_hists
    state = e.get("state")
    tags = {"name": rec.get("name") or "<unnamed>"}
    if state == ev.EXECUTED:
        run = max(
            (x["ts"] for x in rec["events"]
             if x.get("state") == ev.RUNNING
             and x.get("attempt", 0) == e.get("attempt", 0)
             and x.get("ts", 0) <= e.get("ts", 0)),
            default=None,
        )
        if run is not None:
            exec_hist.observe((e["ts"] - run) * 1000, tags)
    elif state in (ev.FINISHED, ev.FAILED):
        sub = min(
            (x["ts"] for x in rec["events"]
             if x.get("state") == ev.SUBMITTED),
            default=None,
        )
        if sub is not None:
            e2e_hist.observe(max(0.0, e["ts"] - sub) * 1000, tags)


class TaskEventAggregator:
    """Bounded store of per-task event timelines + free-floating spans."""

    def __init__(self, max_tasks: Optional[int] = None,
                 max_events_per_task: int = 256,
                 max_profile_events: int = 20_000,
                 max_tasks_per_job: Optional[int] = None):
        self._lock = _san.make_lock("tracing.aggregator")
        self._max_tasks = max_tasks or max(100, _config.task_events_max_tasks)
        self._max_tasks_per_job = max_tasks_per_job or max(
            10, _config.task_events_max_tasks_per_job
        )
        self._max_events_per_task = max_events_per_task
        # task_id -> {"task_id", "name", "actor_id", "job_id", "events": []}
        self._tasks: "OrderedDict[str, dict]" = OrderedDict()
        # per-job retention index: job_id -> OrderedDict[task_id, None] — a
        # chatty job evicts its OWN oldest tasks before it can push another
        # job's history out of the global window
        self._job_tasks: Dict[str, "OrderedDict[str, None]"] = {}
        # spans with no task id (serve request spans, ad-hoc profile spans)
        self._profile: deque = deque(maxlen=max_profile_events)
        # drop accounting, surfaced as metrics
        self._dropped_at_source: Dict[str, int] = {}  # source -> cumulative
        self.evicted_tasks = 0
        self.evicted_per_job: Dict[str, int] = {}
        self.truncated_events = 0

    # ------------------------------------------------------------- ingestion
    def ingest(self, events: List[dict], dropped: int = 0,
               source: Optional[str] = None) -> None:
        with self._lock:
            if source is not None and dropped:
                # sources report a cumulative counter; max() is idempotent
                prev = self._dropped_at_source.get(source, 0)
                self._dropped_at_source[source] = max(prev, int(dropped))
            # WAL recovery replays a dead worker's file; truncation races the
            # kill (flush delivered, worker died before wal_flushed), so a
            # replayed event may already be here. Per-process timestamps are
            # strictly monotonic, making (state, ts, attempt) a reliable
            # identity within one task — recovery is idempotent, duration
            # histograms never double-observe.
            dedup = source is not None and source.startswith("wal-")
            for e in events:
                tid = e.get("task_id")
                if tid is None:
                    self._profile.append(e)
                    continue
                rec = self._tasks.get(tid)
                if dedup and rec is not None:
                    key = (e.get("state"), e.get("ts"), e.get("attempt", 0))
                    if any(
                        (x.get("state"), x.get("ts"), x.get("attempt", 0))
                        == key
                        for x in rec["events"]
                    ):
                        continue
                if rec is None:
                    rec = self._tasks[tid] = {
                        "task_id": tid,
                        "name": e.get("name") or "",
                        "actor_id": e.get("actor_id"),
                        "job_id": e.get("job_id"),
                        "events": [],
                        "profile_count": 0,
                    }
                    self._index_job_locked(tid, rec)
                    self._evict_locked()
                else:
                    self._tasks.move_to_end(tid)
                if not rec["name"] and e.get("name"):
                    rec["name"] = e["name"]
                if rec.get("actor_id") is None and e.get("actor_id"):
                    rec["actor_id"] = e["actor_id"]
                if rec.get("job_id") is None and e.get("job_id"):
                    rec["job_id"] = e["job_id"]
                    self._index_job_locked(tid, rec)
                # the cap truncates PROFILE spans only: lifecycle events are
                # intrinsically bounded (a handful per attempt) and dropping
                # a terminal one would leave a phantom RUNNING state
                if e.get("state") == ev.PROFILE:
                    if rec["profile_count"] >= self._max_events_per_task:
                        self.truncated_events += 1
                        continue
                    rec["profile_count"] += 1
                rec["events"].append(e)
                # WAL replays never drive the duration histograms: the
                # record-level dedup above can't see tasks already evicted
                # from retention, and a rare lost last-second observation
                # beats ever double-counting the SLO series
                if not dedup and e.get("state") in (
                        ev.EXECUTED, ev.FINISHED, ev.FAILED):
                    _observe_task_duration(rec, e)

    def _index_job_locked(self, tid: str, rec: dict) -> None:
        """Record tid under its job and enforce the per-job cap (evicting
        the job's own oldest tasks; jobless events ride only the global
        cap)."""
        job = rec.get("job_id")
        if job is None:
            return
        per = self._job_tasks.setdefault(job, OrderedDict())
        per[tid] = None
        while len(per) > self._max_tasks_per_job:
            old_tid, _ = per.popitem(last=False)
            if self._tasks.pop(old_tid, None) is not None:
                self.evicted_tasks += 1
                self.evicted_per_job[job] = (
                    self.evicted_per_job.get(job, 0) + 1
                )

    def _evict_locked(self) -> None:
        while len(self._tasks) > self._max_tasks:
            tid, rec = self._tasks.popitem(last=False)
            job = rec.get("job_id")
            if job is not None:
                per = self._job_tasks.get(job)
                if per is not None:
                    per.pop(tid, None)
                    if not per:
                        del self._job_tasks[job]
            self.evicted_tasks += 1

    # ------------------------------------------------- snapshot (durability)
    def dump(self) -> dict:
        """Copy-out of the whole aggregation state for the GCS snapshot
        (head-plane durability): a restarted GCS keeps per-job history and
        closed timelines instead of starting blind. Event dicts are never
        mutated after ingest, so per-record shallow copies suffice."""
        with self._lock:
            return {
                "tasks": [
                    (tid, {**rec, "events": list(rec["events"])})
                    for tid, rec in self._tasks.items()
                ],
                "profile": list(self._profile),
                "dropped_at_source": dict(self._dropped_at_source),
                "evicted_tasks": self.evicted_tasks,
                "evicted_per_job": dict(self.evicted_per_job),
                "truncated_events": self.truncated_events,
            }

    def restore(self, state: Optional[dict]) -> None:
        """Load a dump() (restart restore). Replaces current state; the
        per-job retention index is rebuilt from the records."""
        if not state:
            return
        with self._lock:
            self._tasks.clear()
            self._job_tasks.clear()
            for tid, rec in state.get("tasks", []):
                self._tasks[tid] = rec
                job = rec.get("job_id")
                if job is not None:
                    self._job_tasks.setdefault(job, OrderedDict())[tid] = None
            self._profile.clear()
            self._profile.extend(state.get("profile", ()))
            self._dropped_at_source = dict(
                state.get("dropped_at_source", {})
            )
            self.evicted_tasks = state.get("evicted_tasks", 0)
            self.evicted_per_job = dict(state.get("evicted_per_job", {}))
            self.truncated_events = state.get("truncated_events", 0)

    # --------------------------------------------------------------- queries
    @staticmethod
    def _latest(rec: dict) -> dict:
        evs = sorted(rec["events"], key=lambda e: e.get("ts", 0))
        states = [e["state"] for e in evs if e["state"] != ev.PROFILE]
        state = _terminal_state(states) or (states[-1] if states else "UNKNOWN")
        last = evs[-1] if evs else {}
        return {
            "task_id": rec["task_id"],
            "name": rec["name"],
            "state": state,
            "actor_id": rec.get("actor_id"),
            "node_id": last.get("node_id"),
            "worker": last.get("worker"),
            "trace_id": next(
                (e["trace_id"] for e in evs if e.get("trace_id")), None
            ),
            "time": last.get("ts"),
            "num_events": len(evs),
        }

    def get_task(self, task_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._tasks.get(task_id)
            if rec is None:
                return None
            out = self._latest(rec)
            out["events"] = sorted(
                rec["events"], key=lambda e: e.get("ts", 0)
            )
            out["dropped_at_source"] = sum(self._dropped_at_source.values())
            return out

    def list_tasks(self, limit: int = 1000) -> List[dict]:
        with self._lock:
            recs = list(self._tasks.values())[-limit:]
            return [self._latest(r) for r in recs]

    def summarize(self) -> dict:
        """Counts by function name and state (state-API summarize_tasks)."""
        with self._lock:
            by_name: Dict[str, Dict[str, int]] = {}
            for rec in self._tasks.values():
                row = self._latest(rec)
                per = by_name.setdefault(row["name"] or "<unnamed>", {})
                per[row["state"]] = per.get(row["state"], 0) + 1
            return {
                "tasks": by_name,
                "total_tasks": len(self._tasks),
                "dropped_at_source": sum(self._dropped_at_source.values()),
                "evicted_tasks": self.evicted_tasks,
                "evicted_per_job": dict(self.evicted_per_job),
                "truncated_events": self.truncated_events,
            }

    def timeline_events(self, limit: int = 50_000) -> List[dict]:
        """Flat, time-sorted event list for Chrome-trace export."""
        with self._lock:
            out: List[dict] = []
            for rec in self._tasks.values():
                out.extend(rec["events"])
            out.extend(self._profile)
        out.sort(key=lambda e: e.get("ts", 0))
        return out[-limit:]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "task_events_tasks": len(self._tasks),
                "task_events_dropped_at_source": sum(
                    self._dropped_at_source.values()
                ),
                "task_events_evicted_tasks": self.evicted_tasks,
                "task_events_truncated": self.truncated_events,
            }

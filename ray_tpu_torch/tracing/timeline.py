"""Chrome-trace / Perfetto export of aggregated task events.

Parity: ``ray timeline`` (python/ray/_private/state.py chrome_tracing_dump).
Layout: one trace *process* row per node, one *thread* row per worker
process on it. Lifecycle pairs (RUNNING → EXECUTED/FINISHED/FAILED) render
as complete ("X") slices; every other lifecycle transition and zero-length
profile event renders as an instant ("i"); profile spans with a duration
render as "X" slices on the worker that recorded them.

Every emitted event carries pid/tid/ts/ph/name so the file loads in
chrome://tracing and Perfetto unmodified.

The port's copy of ray_tpu/tracing/timeline.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.tracing import events as ev

_END_STATES = (ev.EXECUTED, ev.FINISHED, ev.FAILED)


def build_chrome_trace(events: List[dict]) -> List[dict]:
    """Convert a flat task-event list (aggregator.timeline_events) into a
    Chrome-trace JSON event array."""
    events = sorted(events, key=lambda e: e.get("ts", 0))
    # ---------------------------------------------------- row assignment
    # pid per node, tid per worker process — "one row per node/worker"
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    out: List[dict] = []

    def row(e: dict) -> Tuple[int, int]:
        node = str(e.get("node_id") or "driver")
        worker = str(e.get("worker") or e.get("component") or "process")
        if node not in pids:
            pids[node] = len(pids) + 1
            out.append({
                "name": "process_name", "ph": "M", "ts": 0,
                "pid": pids[node], "tid": 0,
                "args": {"name": f"node {node}"},
            })
        key = (node, worker)
        if key not in tids:
            tids[key] = len(tids) + 1
            out.append({
                "name": "thread_name", "ph": "M", "ts": 0,
                "pid": pids[node], "tid": tids[key],
                "args": {"name": f"worker {worker}"},
            })
        return pids[node], tids[key]

    def base_args(e: dict) -> dict:
        args = {
            k: e[k]
            for k in ("task_id", "state", "attempt", "trace_id", "actor_id")
            if e.get(k) is not None
        }
        args.update(e.get("args") or {})
        return args

    # ------------------------------------------- lifecycle span pairing
    # group by (task_id, attempt); pair each RUNNING with the next
    # worker/owner end state at ts >= start
    by_task: Dict[Tuple[str, int], List[dict]] = {}
    for e in events:
        tid = e.get("task_id")
        if tid is not None and e.get("state") in ev.LIFECYCLE_STATES:
            by_task.setdefault((tid, e.get("attempt", 0)), []).append(e)

    paired_ends: set = set()
    paired_starts: set = set()
    for (task_id, _attempt), evs in by_task.items():
        for i, e in enumerate(evs):
            if e["state"] != ev.RUNNING:
                continue
            end = next(
                (x for x in evs[i + 1:] if x["state"] in _END_STATES), None
            )
            if end is None:
                continue
            paired_ends.add(id(end))
            paired_starts.add(id(e))
            pid, tid = row(e)
            out.append({
                "name": e.get("name") or "task",
                "cat": "actor_task" if e.get("actor_id") else "task",
                "ph": "X",
                "ts": e["ts"] * 1e6,
                "dur": max(0.0, (end["ts"] - e["ts"]) * 1e6),
                "pid": pid,
                "tid": tid,
                "args": {**base_args(e), "end_state": end["state"]},
            })

    # ------------------------------------------------- remaining events
    for e in events:
        state = e.get("state")
        if state == ev.PROFILE:
            pid, tid = row(e)
            dur = e.get("dur")
            entry = {
                "name": e.get("name") or "span",
                "cat": e.get("component") or "user",
                "ph": "X" if dur else "i",
                "ts": (e["ts"] - (dur or 0.0)) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": base_args(e),
            }
            if dur:
                entry["dur"] = dur * 1e6
            else:
                entry["s"] = "t"
            out.append(entry)
        elif state in ev.LIFECYCLE_STATES:
            if id(e) in paired_ends or id(e) in paired_starts:
                continue  # already an edge of an X slice
            pid, tid = row(e)
            out.append({
                # suffix the state so span filters on the bare task name
                # (e.g. chrome-trace queries, the repo's own tests) only
                # see the X slices
                "name": f"{e.get('name') or 'task'}:{state}",
                "cat": "lifecycle",
                "ph": "i",
                "s": "t",
                "ts": e["ts"] * 1e6,
                "pid": pid,
                "tid": tid,
                "args": base_args(e),
            })
    out.sort(key=lambda x: x.get("ts", 0))
    return out

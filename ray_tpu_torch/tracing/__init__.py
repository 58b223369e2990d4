"""Distributed task-event tracing: every process buffers per-task lifecycle
events into a bounded, drop-counting :class:`TaskEventBuffer`; the runtime
flushes batches to a GCS-side :class:`TaskEventAggregator` that backs the
state API (``get_task`` / ``summarize_tasks``) and ``ray_tpu_torch.timeline()``
(Chrome-trace export, one row per node/worker).

Parity: src/ray/core_worker/task_event_buffer.h (per-worker bounded event
buffer, periodic GCS flush) + gcs_task_manager.h (bounded aggregation) +
``ray timeline``.

Model
-----
- Lifecycle states (``SUBMITTED → LEASED → DISPATCHED → RUNNING → EXECUTED
  → FINISHED | FAILED``) are recorded at the layer that observes them: the
  owner records submit/dispatch/terminal states, the raylet records the
  lease grant, the executing worker records run/executed.
- One ``trace_id`` is minted per logical request (e.g. a serve request) and
  propagated through ``TaskSpec`` into every nested submission, so a single
  request stitches across processes in the exported timeline.
- ``profile_span("name")`` records user spans into the same plane, tagged
  with the current task/trace.

Cheap by default: recording is a couple of dict writes behind one lock;
``task_events_enabled=False`` reduces it to a single attribute check, and
``task_events_sample_rate < 1`` keeps/drops whole traces deterministically
(hash of the trace/task id), so a sampled request is never half-recorded.

The port's copy of ray_tpu/tracing/: the same event format, sampling,
WAL lines and Chrome-trace export, so an event list or a WAL written by
either package reads back in the other.
"""

from ray_tpu_torch.tracing.events import (
    LIFECYCLE_STATES,
    TERMINAL_STATES,
    TaskEventBuffer,
    current_deadline,
    current_job_id,
    current_task_id,
    current_trace_id,
    deadline_context,
    ensure_trace,
    get_buffer,
    new_trace_id,
    profile_span,
    read_wal,
    remaining_time_s,
    task_context,
    trace_context,
)
from ray_tpu_torch.tracing.aggregator import TaskEventAggregator
from ray_tpu_torch.tracing.timeline import build_chrome_trace

__all__ = [
    "LIFECYCLE_STATES",
    "TERMINAL_STATES",
    "TaskEventBuffer",
    "TaskEventAggregator",
    "build_chrome_trace",
    "current_deadline",
    "current_job_id",
    "current_task_id",
    "current_trace_id",
    "deadline_context",
    "remaining_time_s",
    "ensure_trace",
    "get_buffer",
    "new_trace_id",
    "profile_span",
    "read_wal",
    "task_context",
    "trace_context",
]

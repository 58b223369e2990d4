"""Exception hierarchy.

The port's copy of ray_tpu/exceptions.py: the same class names and
hierarchy (they are distinct classes, so compare them by name).
Parity: python/ray/exceptions.py — RayTaskError wraps the remote traceback and is
re-raised at `get`; actor/object/worker failures get dedicated types so user code
can react (retry, restore from checkpoint, …).
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray_tpu.get()."""

    def __init__(self, cause_cls_name: str, traceback_str: str, cause=None):
        self.cause_cls_name = cause_cls_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"task failed with {cause_cls_name}\n"
            f"--- remote traceback ---\n{traceback_str}"
        )

    @staticmethod
    def from_exception(e: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
        # keep the original exception when picklable so `except UserError` works
        try:
            import cloudpickle

            cloudpickle.dumps(e)
            cause = e
        except Exception:
            cause = None
        return TaskError(type(e).__name__, tb, cause)

    def as_instanceof_cause(self):
        return self.cause if self.cause is not None else self

    def __reduce__(self):
        return (TaskError, (self.cause_cls_name, self.traceback_str, self.cause))


class TaskCancelledError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died (OOM-kill, segfault, chaos test…)."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id=None, reason: str = ""):
        self.actor_id = actor_id
        super().__init__(f"actor {actor_id} died: {reason}")


class ActorUnavailableError(ActorError):
    """Actor is restarting; the call may be retried."""


class ObjectLostError(RayTpuError):
    """Object data was lost (node death / eviction) and could not be
    reconstructed from lineage."""

    def __init__(self, object_id=None, reason: str = ""):
        self.object_id = object_id
        super().__init__(f"object {object_id} lost: {reason}")


class ObjectStoreFullError(RayTpuError):
    pass


class GcsUnavailableError(RayTpuError):
    """The head plane (GCS) stayed unreachable across the whole retry
    window. With head-plane durability a restarted GCS re-answers on the
    same address within ~seconds, so in-flight control-plane waiters
    (``get_actor``, ``get_channel_endpoint``, function registration) retry
    behind the standard backoff policy and raise THIS — never a raw
    ``ConnectionLost`` — when the head genuinely did not come back."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline expired before (or while) the work
    ran. Minted at the serve proxy/handle (``request_timeout_s`` or the
    client's timeout header), the deadline rides the task context and
    ``TaskSpec`` into nested calls; every hop sheds expired work *before*
    dispatch/execution, so an abandoned request never burns replica time."""


class BackPressureError(RayTpuError):
    """Admission control rejected the request: the deployment's queue bound
    (``max_queued_requests``) or a replica's ``max_ongoing_requests`` is
    full, or every replica's circuit breaker is open. Retryable by the
    CLIENT after backing off (HTTP 503 + Retry-After at the proxy); the
    framework itself never retries these — that would amplify the overload."""


class RetryBudgetExhaustedError(RayTpuError):
    """A failover retry was wanted but the deployment's retry token bucket
    (a bounded fraction of recent request volume) is empty — the original
    failure surfaces instead of joining a retry storm."""


class RuntimeEnvSetupError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass

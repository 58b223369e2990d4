"""Backend interface: the seam between the public API and a runtime.

The port's copy of ray_tpu/core/backend.py, unchanged. Implementations:
- ``LocalBackend`` (local_backend.py): in-process, thread-based — the analog of the
  reference's LOCAL_MODE (python/ray/_private/worker.py mode handling). Used for
  unit tests and quick iteration.
- ``ClusterBackend``: the multi-process runtime (GCS + raylets + workers +
  shared-memory object store) of ray_tpu/core/cluster_backend.py, not ported
  yet; it plugs in here.
"""

from __future__ import annotations

import abc
import concurrent.futures
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.options import RemoteOptions
from ray_tpu_torch.core.refs import ObjectRef


class Backend(abc.ABC):
    @abc.abstractmethod
    def submit_task(
        self, func, args: tuple, kwargs: dict, options: RemoteOptions
    ) -> Sequence[ObjectRef]:
        """Submit a stateless task; returns one ref per return value.

        With ``options.num_returns == "streaming"`` the function must be a
        generator and the backend returns an
        ``ObjectRefGenerator`` (the streaming plane, not ported yet) instead — each
        yielded item is pushed to the caller as its own object the moment
        it is produced (same contract for submit_actor_task)."""

    @abc.abstractmethod
    def create_actor(
        self, cls, args: tuple, kwargs: dict, options: RemoteOptions
    ) -> ActorID:
        ...

    @abc.abstractmethod
    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: tuple,
        kwargs: dict,
        options: RemoteOptions,
    ) -> Sequence[ObjectRef]:
        ...

    @abc.abstractmethod
    def put(self, value: Any) -> ObjectRef:
        ...

    def put_batch(self, values: List[Any]) -> List[ObjectRef]:
        """Batched put (ray_tpu_torch.put_many): backends override to amortize
        per-op bookkeeping; the default is a plain loop."""
        return [self.put(v) for v in values]

    @abc.abstractmethod
    def get(self, refs: List[ObjectRef], timeout: Optional[float]) -> List[Any]:
        ...

    @abc.abstractmethod
    def wait(
        self,
        refs: List[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
        fetch_local: bool,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        ...

    @abc.abstractmethod
    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        ...

    @abc.abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        ...

    @abc.abstractmethod
    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        ...

    @abc.abstractmethod
    def shutdown(self) -> None:
        ...

    # --- optional capabilities (cluster backend overrides) -------------------
    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        raise ValueError(f"Failed to look up actor '{name}'")

    def cluster_resources(self) -> Dict[str, float]:
        return {}

    def available_resources(self) -> Dict[str, float]:
        return {}

    def nodes(self) -> List[dict]:
        return []

    def free_actor(self, actor_id: ActorID) -> None:
        """Called when the last local ActorHandle is GC'd (out-of-scope kill)."""

    # --- fault-tolerance plane (compiled graphs, serve failover) -------------
    def actor_state(self, actor_id: ActorID) -> str:
        """Current lifecycle state: PENDING | ALIVE | RESTARTING | DEAD,
        or UNKNOWN when the control plane is unreachable (callers must
        treat UNKNOWN as maybe-alive, never as death)."""
        return "ALIVE"

    def wait_actor_alive(self, actor_id: ActorID, timeout: float) -> None:
        """Block until the actor is ALIVE. Raises ActorDiedError when it is
        (or becomes) DEAD, GetTimeoutError on timeout."""

    def actor_node(self, actor_id: ActorID) -> Optional[str]:
        """Node id the actor currently runs on, or None when unknown (the
        compiled-graph planner reads this at materialize time to choose shm
        vs cross-node stream channels per edge)."""
        return None

    def add_actor_listener(self, cb) -> None:
        """Subscribe ``cb(actor_id_bytes, state, reason)`` to actor lifecycle
        transitions (compiled graphs watch their participants through this)."""

    def remove_actor_listener(self, cb) -> None:
        pass

    def create_deferred(self):
        """Allocate a driver-owned ObjectRef fulfilled later by framework
        code: returns ``(ref, fulfill)`` where ``fulfill(value=..)`` /
        ``fulfill(error=..)`` resolves it, or None when unsupported (serve
        uses this to retry a request behind one stable user-facing ref).
        Backends that also expose ``as_serialized_future(ref)`` accept
        ``fulfill(serialized=bytes)`` so relays can pass a response through
        without deserializing + re-serializing it."""
        return None

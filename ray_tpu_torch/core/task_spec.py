"""TaskSpec: the wire description of a task/actor-task/actor-creation.

Parity: src/ray/common/task/task_spec.h + common.proto TaskSpec. Functions are
content-addressed into the GCS function registry (sha of the cloudpickle
blob), so a hot function crosses the wire once per cluster, not once per call
(reference: python/ray/_private/function_manager.py export path).

The port's copy of ray_tpu/core/task_spec.py; it leaves out the packed
``runtime_env`` (that plane is not ported).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch.core.refs import ObjectRef

# arg encodings
ARG_VALUE = 0   # small value, serialized inline
ARG_REF = 1     # ObjectRef dependency


def function_id(pickled_fn: bytes) -> bytes:
    return hashlib.blake2b(pickled_fn, digest_size=16).digest()


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    fn_id: bytes                      # key into GCS function registry
    args: List[Tuple[int, Any]]       # (ARG_VALUE, bytes) | (ARG_REF, ObjectRef)
    kwargs: Dict[str, Tuple[int, Any]]
    num_returns: int
    resources: Dict[str, float]
    owner_addr: str                   # rpc address of the owning worker
    # job identity (hex-ish string): rides every task event so the GCS
    # aggregator can enforce per-job retention; nested submissions inherit
    # it through the executing worker's task context
    job_id: Optional[str] = None
    max_retries: int = 0
    retry_exceptions: bool = False
    # actor fields
    actor_id: Optional[ActorID] = None         # set for actor tasks
    actor_method: Optional[str] = None
    actor_seq_no: int = 0                      # per-caller ordering
    is_actor_creation: bool = False
    actor_options: Optional[dict] = None       # RemoteOptions fields for creation
    scheduling_strategy: Any = None
    placement_group_id: Any = None
    placement_group_bundle_index: int = -1
    # streaming generators (num_returns="streaming"): the worker pushes each
    # yielded item to the owner as its own object
    # (ObjectID.for_task_return(task_id, index)) instead of returning values
    # in the reply; `backpressure` bounds the producer's unconsumed lead
    streaming: bool = False
    backpressure: Optional[int] = None
    # tracing (ray_tpu_torch/tracing/): one trace id per logical request,
    # propagated into every nested submission so a request stitches across
    # processes; parent_task_id is the submitting task (hex), attempt counts
    # owner-side retries (mutated before each resubmission)
    trace_id: Optional[str] = None
    parent_task_id: Optional[str] = None
    attempt: int = 0
    # overload protection: absolute wall-clock deadline (epoch seconds) of
    # the root request, inherited by nested submissions via the worker task
    # context. Expired specs are shed typed (DeadlineExceededError) before
    # dispatch at the owner AND before execution at the worker — abandoned
    # requests never burn worker time.
    deadline: Optional[float] = None
    # clock-skew guard: the owner's wall and monotonic clocks AT SUBMISSION
    # (set whenever deadline is). The receiving host uses the pair to
    # re-anchor the deadline into its own clock domain (effective_deadline)
    # so NTP skew beyond deadline_skew_tolerance_s clamps instead of
    # falsely shedding live work.
    deadline_minted_wall: Optional[float] = None
    deadline_minted_mono: Optional[float] = None

    def return_refs(self) -> List[ObjectRef]:
        return [
            ObjectRef(
                ObjectID.for_task_return(self.task_id, i),
                owner_addr=self.owner_addr,
                task_id=self.task_id,
            )
            for i in range(max(1, self.num_returns))
        ]

    def dependencies(self) -> List[ObjectRef]:
        deps = [a[1] for a in self.args if a[0] == ARG_REF]
        deps += [a[1] for a in self.kwargs.values() if a[0] == ARG_REF]
        return deps


def effective_deadline(deadline: Optional[float],
                       minted_wall: Optional[float],
                       minted_mono: Optional[float],
                       now_wall: Optional[float] = None,
                       now_mono: Optional[float] = None,
                       tolerance_s: Optional[float] = None,
                       ) -> Optional[float]:
    """Translate an owner-minted wall-clock deadline into the RECEIVING
    process's clock domain (the PR-10 multi-host skew gap).

    Two regimes, picked from the spec's minted ``(wall, mono)`` pair:

    * **Same boot** (CLOCK_MONOTONIC is system-wide, so owner and receiver
      on one host share it): the wall/mono offsets agree within the
      tolerance, and the EXACT elapsed time since mint comes from the
      monotonic delta — immune to NTP step adjustments mid-flight.
    * **Cross-host**: monotonic clocks are boot-relative and incomparable,
      so the offsets disagree wildly and only wall clocks are shared. The
      mint-to-receipt wall delta should be ~transit time; when it falls
      outside ``[-tolerance, tolerance]`` the difference is dominated by
      NTP skew (or extreme queueing, indistinguishable without a shared
      clock) and the remaining budget is re-anchored to the receiver's
      clock — the request keeps the time its owner granted it, it is
      never falsely shed on a clock disagreement. Within the tolerance the
      minted deadline is used as-is, so sheds stay exact up to the
      documented skew bound.

      The deliberate cost: a cross-host request that sat queued past the
      tolerance under genuine overload gets its budget re-granted here
      instead of shed — worker-side shedding degrades for that slice.
      Bounded by design: the re-grant happens at most ONCE per hop
      (localize_deadline is one-shot, and nested specs mint a fresh pair
      from the already-localized context), and the owner/router-side
      sheds — which share the minting clock and need no guard — still
      fire exactly. Shedding live work on what might be a skewed clock
      was judged the worse failure.

    Pure function of its inputs (``now_*`` injectable for tests); time
    sources default to the caller's clocks, read in separate statements —
    never mixed in one expression (raylint RT007).
    """
    if deadline is None:
        return None
    if minted_wall is None:
        return deadline
    from ray_tpu_torch.core.config import _config

    tol = (_config.deadline_skew_tolerance_s
           if tolerance_s is None else tolerance_s)
    if now_wall is None:
        now_wall = time.time()
    if now_mono is None:
        now_mono = time.monotonic()
    budget = deadline - minted_wall
    if minted_mono is not None:
        my_offset = now_wall - now_mono
        owner_offset = minted_wall - minted_mono
        if abs(my_offset - owner_offset) <= tol:
            # shared monotonic domain: exact elapsed since mint
            elapsed = now_mono - minted_mono
            return now_wall + (budget - elapsed)
    transit = now_wall - minted_wall
    if transit < -tol or transit > tol:
        # clocks provably (or plausibly) disagree past the tolerance:
        # clamp — restart the owner-granted budget on OUR clock rather
        # than shed live work on a skewed comparison
        return now_wall + budget
    return deadline


def localize_deadline(spec: "TaskSpec") -> Optional[float]:
    """One-shot, at the spec's arrival in a receiving process: rewrite
    ``spec.deadline`` into the local clock domain via effective_deadline
    (subsequent reads — shed checks, nested task context — see the
    localized value)."""
    if getattr(spec, "_deadline_localized", False):
        return spec.deadline
    spec._deadline_localized = True
    spec.deadline = effective_deadline(
        spec.deadline,
        getattr(spec, "deadline_minted_wall", None),
        getattr(spec, "deadline_minted_mono", None),
    )
    return spec.deadline


def encode_args(args, kwargs, put_fn, inline_limit: int = 100 * 1024):
    """Encode call args: ObjectRefs pass by reference; values serialize inline
    when small, else spill to the object store via put_fn(value)->ObjectRef
    (reference behavior: direct_task_transport inlines small args). Inline
    payloads past the wire's OOB threshold stay as SerializedObjects so
    push_task frames write their buffers straight from the source memory
    via the v2 out-of-band segment table (zero-copy; the worker maps them
    back as views over the frame body). Zero-copy rule: treat task args as
    immutable until the task settles — a retry re-sends the same views."""
    from ray_tpu_torch.core.config import _config

    def enc(v):
        if isinstance(v, ObjectRef):
            return (ARG_REF, v)
        s = serialization.serialize(v)
        if s.total_bytes() > inline_limit:
            return (ARG_REF, put_fn(v))
        if s.total_bytes() >= _config.rpc_oob_threshold_bytes:
            # the SerializedObject itself rides the frame pickler: its
            # buffers go out-of-band straight from their source memory (no
            # to_bytes flatten here, no from_buffer re-parse on the worker)
            return (ARG_VALUE, s)
        return (ARG_VALUE, s.to_bytes())

    return [enc(a) for a in args], {k: enc(v) for k, v in kwargs.items()}


def decode_args(enc_args, enc_kwargs, get_fn):
    """get_fn(list_of_refs) -> list_of_values (batched dependency fetch)."""
    from ray_tpu_torch.core import rpc

    refs = [v for (t, v) in enc_args if t == ARG_REF]
    refs += [v for (t, v) in enc_kwargs.values() if t == ARG_REF]
    fetched = iter(get_fn(refs)) if refs else iter(())
    resolved = {id(r): None for r in refs}
    for r in refs:
        resolved[id(r)] = next(fetched)

    def dec(t, v):
        if t == ARG_REF:
            return resolved[id(v)]
        v = rpc.unwrap_oob(v)
        if isinstance(v, serialization.SerializedObject):
            return serialization.deserialize(v)
        return serialization.loads(v)

    args = [dec(t, v) for (t, v) in enc_args]
    kwargs = {k: dec(t, v) for k, (t, v) in enc_kwargs.items()}
    return args, kwargs

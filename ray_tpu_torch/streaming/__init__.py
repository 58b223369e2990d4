"""Streaming generators: push-based incremental task/actor-method outputs.

Parity: the reference's streaming-generator path (``num_returns="streaming"``
→ ``ObjectRefGenerator``, src/ray/core_worker/task_manager streaming-generator
return handling) — the core mechanism behind token streaming in LLM serving
stacks and streaming data exchange.

Model
-----
A generator function (or actor method) declared with
``.options(num_returns="streaming")`` executes on the worker and **pushes**
each yielded item into the caller-visible store as its own sealed object the
moment it is produced. The caller receives an :class:`ObjectRefGenerator` and
iterates per-item ``ObjectRef``\\ s (sync or async); ``ray_tpu_torch.get`` on each
ref resolves the item value.

Failure semantics
-----------------
- a mid-stream **user exception** becomes the value of the exact item that
  raised: iteration keeps yielding every item produced before it, then
  ``get`` on the failing item re-raises the user error, then the stream ends;
- **producer death** (worker crash, actor kill, chaos injection) fails the
  stream: every item already pushed stays consumable, and the next item
  raises a typed error (``ActorDiedError`` for actor streams,
  ``WorkerCrashedError`` for task streams) instead of hanging;
- end-of-stream is typed: ``StopIteration`` (sync) / ``StopAsyncIteration``
  (async).

Backpressure
------------
``generator_backpressure_num_objects=W`` bounds the producer's lead: the
producing worker blocks in ``yield`` until the consumer drains, keeping at
most ``W + 1`` items in flight. Without it, the producer pipelines up to
``generator.MAX_INFLIGHT_ITEMS`` un-acked pushes.

The port's copy of ray_tpu/streaming/: an item that is a CUDA tensor
travels by the port's CUDA-tensor serialization (its bytes through the
host) and the owner's ``get`` gives back its host copy, a CPU tensor, as
the reference's owner gets a ``jax.Array`` item back as numpy. The owner
counts the items and exports its backlog as metrics (generator.py).
"""

from ray_tpu_torch.streaming.generator import EndOfStream, ObjectRefGenerator, StreamState

__all__ = ["ObjectRefGenerator", "StreamState", "EndOfStream"]

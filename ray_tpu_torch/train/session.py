"""Per-worker training session: report(), get_checkpoint(), rank info.

The port's copy of ray_tpu/train/session.py, unchanged.
Parity: python/ray/air/session.py:43 (report), :97 (get_checkpoint) +
train/_internal/session.py:76 (_TrainSession; report ships metrics+checkpoint
to the driver via a queue :421).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_id: str = ""
    experiment_name: str = ""
    trial_id: str = ""


class _Session:
    """Lives inside a train-worker actor; user train_fn talks to it through
    the module-level functions below."""

    def __init__(self, context: TrainContext,
                 latest_checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.result_queue: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        if checkpoint is not None:
            self.latest_checkpoint = checkpoint
        self.result_queue.put(("report", metrics, checkpoint))

    def finish(self, error: Optional[BaseException] = None):
        self.error = error
        self.result_queue.put(("done", None, None))
        self.finished.set()


_session_lock = threading.Lock()
_current: Optional[_Session] = None


def _set_session(s: Optional[_Session]):
    global _current
    with _session_lock:
        _current = s


def _get_session() -> _Session:
    if _current is None:
        raise RuntimeError(
            "No train session active — call inside a train_loop_per_worker"
        )
    return _current


# ----------------------------------------------------------- public API
def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None):
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().latest_checkpoint


def get_dataset_shard(name: str = "train"):
    """This rank's shard of the Dataset passed to the trainer
    (parity: ray.train.get_dataset_shard / air.session :43)."""
    shards = _get_session().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard {name!r}; trainer datasets={list(shards)}"
        )
    return shards[name]


def get_context() -> TrainContext:
    return _get_session().context


def get_world_rank() -> int:
    return _get_session().context.world_rank


def get_world_size() -> int:
    return _get_session().context.world_size


def get_local_rank() -> int:
    return _get_session().context.local_rank

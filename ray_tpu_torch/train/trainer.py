"""Trainers: TorchTrainer / DataParallelTrainer → Result.

The port's copy of ray_tpu/train/trainer.py, with TorchTrainer in
JaxTrainer's place.
Parity: train/base_trainer.py:68 (BaseTrainer, fit :559),
data_parallel_trainer.py:58, torch/torch_trainer.py:15.
The reference runs fit() as a 1-trial Tune experiment; ours drives the worker
group directly and the Tune layer wraps trainers the same way from above
(tune.Tuner(trainer); the port's Tune runs it through
tune/trainable.py::wrap_function until its controller is ported).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException]
    metrics_dataframe: Optional[List[Dict[str, Any]]] = None
    path: Optional[str] = None

    @property
    def best_checkpoint(self):
        return self.checkpoint


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Adapter so Tune can run this trainer as a trial (reference:
        BaseTrainer.as_trainable — Train is a 1-trial Tune run)."""
        trainer = self

        def trainable(config, _session=None):
            import copy

            t = copy.copy(trainer)
            merged = dict(getattr(t, "train_loop_config", None) or {})
            merged.update(config or {})
            t.train_loop_config = merged
            result = t.fit()
            if result.error:
                raise result.error
            return result.metrics

        trainable.__name__ = type(self).__name__
        return trainable


class DataParallelTrainer(BaseTrainer):
    """SPMD training: the same train_loop_per_worker runs on every worker
    (one per host), with a torch process group connecting them into one
    device mesh."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}

    def fit(self) -> Result:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        cfg = self.scaling_config
        run_cfg = self.run_config
        name = run_cfg.name or f"train-{uuid.uuid4().hex[:6]}"
        failures_left = run_cfg.failure_config.max_failures
        latest_ckpt = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []

        while True:
            group = WorkerGroup(
                cfg.num_workers,
                cfg.worker_resources(),
                experiment_name=name,
                placement_strategy=cfg.placement_strategy,
            )
            try:
                try:
                    group.rendezvous()
                    shards = self._shard_datasets(cfg.num_workers)
                    refs = [
                        w.start_training.remote(
                            self.train_loop_per_worker,
                            self.train_loop_config,
                            latest_ckpt,
                            {k: v[rank] for k, v in shards.items()},
                        )
                        for rank, w in enumerate(group.workers)
                    ]
                    ray_tpu_torch.get(refs, timeout=120)
                    error = self._drive(group, history)
                except Exception as e:  # noqa: BLE001
                    # Worker-process death (ActorDiedError, rpc loss) must flow
                    # into the same FailureConfig retry loop as user-code errors
                    # — elastic restart-from-checkpoint is the whole point
                    # (reference: Tune trial FailureConfig handling).
                    # KeyboardInterrupt/SystemExit are NOT retried: Ctrl-C must
                    # stop training, not restart it.
                    error = e
                if error is None:
                    metrics = history[-1] if history else None
                    ckpt = self._latest_group_checkpoint(group) or latest_ckpt
                    return Result(
                        metrics=metrics,
                        checkpoint=ckpt,
                        error=None,
                        metrics_dataframe=history,
                    )
                latest_ckpt = self._latest_group_checkpoint(group) or latest_ckpt
                if failures_left == 0:
                    return Result(
                        metrics=history[-1] if history else None,
                        checkpoint=latest_ckpt,
                        error=error,
                        metrics_dataframe=history,
                    )
                failures_left -= 1
            finally:
                group.shutdown()

    def _shard_datasets(self, num_workers: int) -> Dict[str, List[Any]]:
        """Row-balanced per-rank shards of every dataset passed to the
        trainer (reference: DataParallelTrainer dataset splitting)."""
        shards: Dict[str, List[Any]] = {}
        for name, ds in self.datasets.items():
            if hasattr(ds, "split"):
                shards[name] = ds.split(num_workers)
            else:
                # non-Dataset (e.g. a list): every rank sees the whole thing
                shards[name] = [ds] * num_workers
        return shards

    def _drive(self, group: WorkerGroup, history) -> Optional[BaseException]:
        """Collect every rank's reports until all workers finish (reference:
        the driver consumes all session queues, train/_internal/session.py:421;
        rank-0-only recording would drop the other ranks).

        `history` entries are rank-0 metrics (the canonical per-step row, as
        the reference surfaces to Tune) with the other ranks' metrics for the
        same report index attached under "_all_ranks"."""
        import ray_tpu_torch
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch.core.config import _config

        done = [False] * group.num_workers
        self._last_checkpoint = None
        per_rank: List[List[Dict[str, Any]]] = [[] for _ in range(group.num_workers)]
        emitted = 0
        while not all(done):
            try:
                events = ray_tpu_torch.get(
                    [w.poll.remote(1.0) for w in group.workers],
                    timeout=_config.train_poll_timeout_s,
                )
            except exc.ActorError:
                raise  # already a typed worker-death error
            except exc.GetTimeoutError:
                # a slow round OR a wedged/dead worker: probe liveness so a
                # death surfaces typed instead of as an opaque timeout
                group.check_alive()
                raise
            except exc.RayTpuError as e:
                # raw RPC/submission failure: if a worker is gone, surface
                # THAT (check_alive raises ActorDiedError); otherwise wrap
                # as a worker-crash so FailureConfig still catches it
                group.check_alive()
                raise exc.WorkerCrashedError(
                    f"train worker poll failed: {e}"
                ) from e
            for rank, evs in enumerate(events):
                for kind, metrics, ckpt in evs:
                    if kind == "done":
                        done[rank] = True
                    elif kind == "report":
                        per_rank[rank].append(metrics)
                        if ckpt is not None and rank == 0:
                            self._last_checkpoint = ckpt
            # emit rows once every live rank has reported that index
            live = [r for r in range(group.num_workers)]
            while all(len(per_rank[r]) > emitted or done[r] for r in live):
                row_ranks = [r for r in live if len(per_rank[r]) > emitted]
                if not row_ranks:
                    break
                lead = per_rank[0][emitted] if len(per_rank[0]) > emitted else per_rank[row_ranks[0]][emitted]
                row = dict(lead)
                row["_all_ranks"] = {
                    r: per_rank[r][emitted] for r in row_ranks
                }
                history.append(row)
                emitted += 1
            time.sleep(0.05)
        for w in group.workers:
            try:
                ray_tpu_torch.get(w.get_error.remote(), timeout=60)
            except Exception as e:  # noqa: BLE001
                return e
        return None

    def _latest_group_checkpoint(self, group):
        return getattr(self, "_last_checkpoint", None)


class TorchTrainer(DataParallelTrainer):
    """The flagship trainer (the reference Ray's TorchTrainer; ray_tpu's
    JaxTrainer). Each worker runs the user train loop on its card; the loop
    builds the model and its step (see models/gpt2 + train/train_step for
    the canonical step), over a mesh of the group's process group when it
    gives one."""

"""Train worker group: N actors, one per host, running user train loops.

The port's copy of ray_tpu/train/worker_group.py. The rendezvous is the
reference Ray's again: a torch process group (NCCL on cards, gloo on the
CPU; parallel.mesh.init_distributed) against worker 0's coordinator port,
in `setup_torch_distributed`, where ray_tpu calls jax.distributed.initialize.
The in-process runtime runs one worker: a group of more needs placement
groups and worker processes, which come with the multi-process runtime, and
raises NotImplementedError until then (ray_tpu's local mode fails there
too, with an AttributeError).
Parity: train/_internal/worker_group.py:100 (WorkerGroup of plain actors) +
backend_executor.py:45 (BackendExecutor: start → rendezvous → start_training).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _Session, _set_session


class TrainWorker:
    """Actor hosting one rank's train loop (run on its own thread so poll()
    stays responsive on the actor's ordered queue)."""

    def __init__(self, rank: int, world_size: int, experiment_name: str = ""):
        self.rank = rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.session: Optional[_Session] = None
        self._thread: Optional[threading.Thread] = None
        self._distributed_ready = False

    # ---------------------------------------------------------- rendezvous
    def setup_torch_distributed(self, coordinator: str, num_processes: int,
                                process_id: int) -> bool:
        """The default torch process group over the workers — the NCCL
        rendezvous the reference Ray does and ray_tpu's jax.distributed
        replaced: NCCL where a card is visible, gloo otherwise, over
        tcp://<coordinator>.

        Re-entrant, as the reference's is: a second call tears the group of
        the first down before it joins the new one (torch refuses to
        initialise the default group twice)."""
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import init_distributed

        if self._distributed_ready:
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - half-initialized state
                pass
            self._distributed_ready = False
        init_distributed(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator}",
            rank=process_id,
            world_size=num_processes,
        )
        self._distributed_ready = True
        return True

    # ------------------------------------------------------------ training
    def start_training(self, fn: Callable, config: Dict[str, Any],
                       latest_checkpoint: Optional[Checkpoint] = None,
                       dataset_shards: Optional[Dict[str, Any]] = None) -> bool:
        ctx = TrainContext(
            world_rank=self.rank,
            world_size=self.world_size,
            local_rank=0,
            experiment_name=self.experiment_name,
        )
        self.session = _Session(ctx, latest_checkpoint, dataset_shards)

        def run():
            _set_session(self.session)
            try:
                fn(config) if config is not None else fn()
                self.session.finish()
            except BaseException as e:  # noqa: BLE001
                traceback.print_exc()
                self.session.finish(error=e)
            finally:
                _set_session(None)

        self._thread = threading.Thread(target=run, daemon=True, name="train-fn")
        self._thread.start()
        return True

    def poll(self, timeout: float = 1.0) -> List[tuple]:
        """Drain pending (kind, metrics, checkpoint) events."""
        out = []
        if self.session is None:
            return out
        deadline = time.monotonic() + timeout
        while True:
            try:
                remaining = max(0.0, deadline - time.monotonic())
                item = self.session.result_queue.get(timeout=remaining)
                out.append(item)
                if item[0] == "done":
                    break
            except Exception:  # noqa: BLE001 - queue.Empty
                break
        return out

    def get_error(self):
        if self.session and self.session.error is not None:
            raise self.session.error
        return None

    def shutdown_worker(self) -> bool:
        return True


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 experiment_name: str = "", placement_strategy: str = "PACK"):
        if num_workers > 1:
            raise NotImplementedError(
                f"num_workers={num_workers}: a group of more than one train "
                "worker needs placement groups and a torch process group "
                "across worker processes, which come with the multi-process "
                "runtime, not ported yet (ROADMAP Queue A); the in-process "
                "runtime runs one worker"
            )
        self.num_workers = num_workers
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        opts: Dict[str, Any] = {
            "num_cpus": resources_per_worker.get("CPU", 1),
            "resources": {
                k: v for k, v in resources_per_worker.items() if k not in ("CPU", "GPU")
            },
        }
        if resources_per_worker.get("GPU"):
            opts["num_gpus"] = resources_per_worker["GPU"]
        self.workers = [
            actor_cls.options(**opts).remote(rank, num_workers, experiment_name)
            for rank in range(num_workers)
        ]

    def for_all(self, method: str, *args, timeout: Optional[float] = 120, **kwargs):
        refs = [
            getattr(w, method).remote(*args, **kwargs) for w in self.workers
        ]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def check_alive(self) -> None:
        """Raise a typed worker-death error if any worker actor is gone.

        The trainer's drive loop calls this when a poll round fails or
        times out, so a worker death surfaces as a catchable
        ActorDiedError into the FailureConfig retry loop — never as a bare
        hang or a raw RPC error string."""
        from ray_tpu_torch.api import _global_worker

        backend = _global_worker().backend
        for rank, w in enumerate(self.workers):
            state = backend.actor_state(w._actor_id)
            if state == "DEAD":
                raise ray_tpu_torch.exceptions.ActorDiedError(
                    w._actor_id,
                    f"train worker rank {rank} died mid-run",
                )

    def rendezvous(self):
        """torch.distributed bootstrap across the group: a no-op for the
        one worker the in-process runtime runs, as it is for one worker in
        the reference. The multi-process runtime brings the rendezvous of
        more, through TrainWorker.setup_torch_distributed."""
        return

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass

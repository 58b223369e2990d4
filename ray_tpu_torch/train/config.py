"""Train/AIR config dataclasses.

The port's copy of ray_tpu/train/config.py with GPUs in the TPUs' place:
`use_gpu` and `gpus_per_worker` replace `use_tpu` and `tpus_per_worker`,
`worker_resources()` asks for "GPU", and `mesh` is a
ray_tpu_torch.parallel.mesh.MeshSpec. FailureConfig, CheckpointConfig and
RunConfig are unchanged.
Parity: python/ray/air/config.py — ScalingConfig (:91), FailureConfig (:523),
CheckpointConfig (:574), RunConfig (:704).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclass
class ScalingConfig:
    num_workers: int = 1              # one per host, each driving its cards
    use_gpu: bool = False
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    gpus_per_worker: int = 0          # cards each worker drives
    mesh: Optional[MeshSpec] = None   # global mesh over all workers' cards
    placement_strategy: str = "PACK"  # keep workers on one host's NVLink

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", float(self.gpus_per_worker or 1))
        return res


@dataclass
class FailureConfig:
    max_failures: int = 0  # trial restarts from latest checkpoint


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1

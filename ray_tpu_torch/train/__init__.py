"""Train: TorchTrainer on the runtime (in-process or worker processes),
checkpoints, the train step, predictors, synthetic data (the port of
ray_tpu/train/)."""

import ray_tpu_torch._vector_math  # noqa: F401  (exact first vector math)

from ray_tpu_torch.train.batch_predictor import (
    BatchPredictor,
    Predictor,
    TorchPredictor,
)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_local_rank,
    get_world_rank,
    get_world_size,
    report,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    Result,
    TorchTrainer,
)

__all__ = [
    "BatchPredictor",
    "Predictor",
    "TorchPredictor",
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "report",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_world_rank",
    "get_world_size",
    "get_local_rank",
    "BaseTrainer",
    "DataParallelTrainer",
    "TorchTrainer",
    "Result",
]

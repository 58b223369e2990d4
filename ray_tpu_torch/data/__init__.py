"""Data layer: lazy block Datasets with streaming execution into the card.

The port's copy of ray_tpu/data/. Blocks are numpy-column dicts,
execution is pull-based over remote tasks and actor pools, and
iter_batches stages each batch in reused pinned host buffers and copies
it to the card on a side stream, ahead of the consumer (iterator.py).
Reference: python/ray/data/.
"""

from ray_tpu_torch.data.dataset import (
    Dataset,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_csv,
    read_json,
    read_parquet,
)
from ray_tpu_torch.data.executor import ActorPoolStrategy

__all__ = [
    "ActorPoolStrategy",
    "Dataset",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_csv",
    "read_json",
    "read_parquet",
]

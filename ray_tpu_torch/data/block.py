"""Blocks: the unit of data a Dataset is made of.

The port's copy of ray_tpu/data/block.py. Parity: python/ray/data/block.py
— a Dataset is a list of ObjectRef[Block] plus per-block metadata. The
reference's canonical block is an Arrow table; ours is a dict of numpy
columns ("batch format" native): the consumer stages contiguous host
arrays into pinned buffers for the copy to the card, and the shm object
store already zero-copies numpy. Arrow/pandas enter only at the IO
boundary (read_parquet/read_csv), imported inside the functions that
read or write files.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

Block = Dict[str, np.ndarray]


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, str]] = None   # column → dtype str


def block_from_rows(rows: Sequence[Any]) -> Block:
    """Rows of dicts → columnar block; scalar rows become {'item': ...}."""
    if not rows:
        return {}
    if isinstance(rows[0], dict):
        keys = rows[0].keys()
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return {"item": np.asarray(list(rows))}


def block_num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def block_size_bytes(block: Block) -> int:
    return int(sum(v.nbytes for v in block.values()))


def block_metadata(block: Block) -> BlockMetadata:
    return BlockMetadata(
        num_rows=block_num_rows(block),
        size_bytes=block_size_bytes(block),
        schema={k: str(v.dtype) for k, v in block.items()},
    )


def block_slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def block_concat(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks], axis=0) for k in keys}


def block_rows(block: Block):
    n = block_num_rows(block)
    keys = list(block.keys())
    if keys == ["item"]:
        for i in range(n):
            yield block["item"][i]
    else:
        for i in range(n):
            yield {k: block[k][i] for k in keys}


def normalize_batch(batch: Any) -> Block:
    """User map_batches output → block (dict of arrays)."""
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return {"item": batch}
    if isinstance(batch, list):
        return block_from_rows(batch)
    raise TypeError(
        f"map_batches fn must return a dict of arrays, ndarray, or list of "
        f"rows; got {type(batch)}"
    )

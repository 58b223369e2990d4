"""Datasources: read tasks producing blocks.

Parity: python/ray/data/datasource/ + read_api.py — each datasource splits
into `ReadTask`s (pure callables returning one block) that the streaming
executor runs as remote tasks. Parquet/CSV go through pyarrow (baked in).
"""

from __future__ import annotations

import glob as glob_mod
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.data.block import Block, block_from_rows

ReadTask = Callable[[], Block]


@dataclass
class RangeDatasource:
    n: int
    parallelism: int = 8

    def read_tasks(self) -> List[ReadTask]:
        tasks = []
        per = max(1, self.n // max(self.parallelism, 1))
        start = 0
        while start < self.n:
            end = min(start + per, self.n)
            # tail merge: avoid a tiny trailing block
            if self.n - end < per // 2:
                end = self.n
            lo, hi = start, end

            def task(lo=lo, hi=hi) -> Block:
                return {"id": np.arange(lo, hi, dtype=np.int64)}

            tasks.append(task)
            start = end
        return tasks


@dataclass
class ItemsDatasource:
    items: Sequence[Any]
    parallelism: int = 8

    def read_tasks(self) -> List[ReadTask]:
        items = list(self.items)
        n = len(items)
        per = max(1, n // max(self.parallelism, 1))
        tasks = []
        start = 0
        while start < n:
            end = min(start + per, n)
            if n - end < per // 2:
                end = n
            chunk = items[start:end]

            def task(chunk=chunk) -> Block:
                return block_from_rows(chunk)

            tasks.append(task)
            start = end
        return tasks


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob_mod.glob(os.path.join(p, "*"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


@dataclass
class ParquetDatasource:
    paths: Any
    columns: Optional[List[str]] = None

    def read_tasks(self) -> List[ReadTask]:
        files = _expand_paths(self.paths)
        cols = self.columns

        def make(path):
            def task() -> Block:
                import pyarrow.parquet as pq

                table = pq.read_table(path, columns=cols)
                return {
                    name: np.asarray(col.to_numpy(zero_copy_only=False))
                    for name, col in zip(table.column_names, table.columns)
                }

            return task

        return [make(p) for p in files]


@dataclass
class CSVDatasource:
    paths: Any

    def read_tasks(self) -> List[ReadTask]:
        files = _expand_paths(self.paths)

        def make(path):
            def task() -> Block:
                import pyarrow.csv as pacsv

                table = pacsv.read_csv(path)
                return {
                    name: np.asarray(col.to_numpy(zero_copy_only=False))
                    for name, col in zip(table.column_names, table.columns)
                }

            return task

        return [make(p) for p in files]


@dataclass
class NumpyDatasource:
    arrays: Sequence[np.ndarray]
    column: str = "data"

    def read_tasks(self) -> List[ReadTask]:
        def make(arr):
            def task() -> Block:
                return {self.column: np.asarray(arr)}

            return task

        return [make(a) for a in self.arrays]

@dataclass
class JSONDatasource:
    """JSON-lines files: one object per line → one block per file."""

    paths: Any

    def read_tasks(self) -> List[ReadTask]:
        files = _expand_paths(self.paths)

        def make(path):
            def task() -> Block:
                import json

                from ray_tpu_torch.data.block import block_from_rows

                rows = []
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            rows.append(json.loads(line))
                return block_from_rows(rows)

            return task

        return [make(p) for p in files]

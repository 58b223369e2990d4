"""Dataset preprocessors: fit on a Dataset, transform as a lazy map.

Parity: python/ray/data/preprocessors/ + preprocessor.py — the AIR
fit/transform layer (scalers, encoders, chains, custom batch mappers).
Fitting aggregates per-block partial statistics through remote tasks (the
driver only combines small partials); transform() chains a map_batches onto
the dataset's lazy plan, so preprocessed data streams into training like
any other pipeline stage.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.dataset import Dataset


class Preprocessor:
    """fit(ds) learns state; transform(ds) applies it lazily."""

    _fitted = False

    def fit(self, ds: Dataset) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds: Dataset) -> Dataset:
        if not self._fitted and self._needs_fit():
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform"
            )
        return ds.map_batches(self._transform_block)

    def fit_transform(self, ds: Dataset) -> Dataset:
        return self.fit(ds).transform(ds)

    # -- subclass hooks ---------------------------------------------------- #
    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds: Dataset) -> None:
        raise NotImplementedError

    def _transform_block(self, block: Block) -> Block:
        raise NotImplementedError


def _column_partials(ds: Dataset, columns: Sequence[str]):
    """Remote per-block (count, sum, sumsq, min, max) per column."""
    import ray_tpu_torch

    cols = list(columns)

    def partial(block: Block):
        out = {}
        for c in cols:
            v = np.asarray(block[c], np.float64)
            out[c] = (v.size, v.sum(), (v * v).sum(),
                      v.min() if v.size else np.inf,
                      v.max() if v.size else -np.inf)
        return out

    run = ray_tpu_torch.remote(num_cpus=0.25)(partial)
    parts = ray_tpu_torch.get(
        [run.remote(r) for r in ds.iter_block_refs()], timeout=600
    )
    combined: Dict[str, List[float]] = {
        c: [0, 0.0, 0.0, np.inf, -np.inf] for c in cols
    }
    for p in parts:
        for c, (n, s, ss, mn, mx) in p.items():
            e = combined[c]
            e[0] += n
            e[1] += s
            e[2] += ss
            e[3] = min(e[3], mn)
            e[4] = max(e[4], mx)
    return combined


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (parity: preprocessors/scaler.py)."""

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds: Dataset) -> None:
        for c, (n, s, ss, _, _) in _column_partials(ds, self.columns).items():
            mean = s / max(n, 1)
            var = max(ss / max(n, 1) - mean * mean, 0.0)
            self.stats_[c] = (mean, float(np.sqrt(var)) or 1.0)

    def _transform_block(self, block: Block) -> Block:
        out = dict(block)
        for c, (mean, std) in self.stats_.items():
            out[c] = ((np.asarray(block[c], np.float64) - mean)
                      / (std or 1.0)).astype(np.float32)
        return out


class MinMaxScaler(Preprocessor):
    """Rescale each column to [0, 1] (constant columns map to 0)."""

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds: Dataset) -> None:
        for c, (_, _, _, mn, mx) in _column_partials(ds, self.columns).items():
            self.stats_[c] = (mn, mx)

    def _transform_block(self, block: Block) -> Block:
        out = dict(block)
        for c, (mn, mx) in self.stats_.items():
            span = (mx - mn) or 1.0
            out[c] = ((np.asarray(block[c], np.float64) - mn)
                      / span).astype(np.float32)
        return out


class LabelEncoder(Preprocessor):
    """Map a column's distinct values to dense int codes (sorted order)."""

    def __init__(self, column: str):
        self.column = column
        self.classes_: Optional[np.ndarray] = None

    def _fit(self, ds: Dataset) -> None:
        import ray_tpu_torch

        col = self.column
        uniq = ray_tpu_torch.remote(num_cpus=0.25)(
            lambda b: np.unique(np.asarray(b[col]))
        )
        parts = ray_tpu_torch.get(
            [uniq.remote(r) for r in ds.iter_block_refs()], timeout=600
        )
        self.classes_ = np.unique(np.concatenate(parts))

    def _transform_block(self, block: Block) -> Block:
        out = dict(block)
        vals = np.asarray(block[self.column])
        idx = np.searchsorted(self.classes_, vals)
        bad = (idx >= len(self.classes_)) | (
            self.classes_[np.clip(idx, 0, len(self.classes_) - 1)] != vals
        )
        if bad.any():
            unseen = sorted({str(v) for v in np.asarray(vals)[bad][:5]})
            raise ValueError(
                f"LabelEncoder({self.column!r}): labels not seen at fit "
                f"time: {unseen}"
            )
        out[self.column] = idx.astype(np.int64)
        return out


class BatchMapper(Preprocessor):
    """Stateless user-function preprocessor (parity: BatchMapper)."""

    def __init__(self, fn: Callable[[Block], Block]):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds: Dataset) -> None:
        pass

    def _transform_block(self, block: Block) -> Block:
        return self.fn(block)


class Chain(Preprocessor):
    """Apply preprocessors in sequence; fit runs left to right, each stage
    fitting on the output of the previous ones."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def _fit(self, ds: Dataset) -> None:
        cur = ds
        for p in self.preprocessors:
            cur = p.fit(cur).transform(cur).materialize()

    def transform(self, ds: Dataset) -> Dataset:
        cur = ds
        for p in self.preprocessors:
            cur = p.transform(cur)
        return cur

    def fit_transform(self, ds: Dataset) -> Dataset:
        self.fit(ds)
        self._fitted = True
        return self.transform(ds)

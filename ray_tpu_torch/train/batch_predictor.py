"""Batch inference: a Predictor over Dataset.map_batches.

The port's copy of ray_tpu/train/batch_predictor.py. Parity:
train/predictor.py (`Predictor.from_checkpoint/predict`) +
train/batch_predictor.py (`BatchPredictor.predict` — runs the predictor
as a callable class on an actor pool so each worker loads the model ONCE
and streams batches through it).

`TorchPredictor` takes the place of `JaxPredictor`: it loads
{"params": ...} from a Checkpoint, puts the model on an explicit device
once ("cuda" unless the caller asks for the CPU), and maps numpy batches
to numpy predictions under torch.inference_mode(). `BatchPredictor` maps
it over a Dataset (ray_tpu_torch.data); when the predictor's device is a
card, each actor of the pool holds a GPU lease of one card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Base predictor: load from a Checkpoint, map batch → batch."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


def _to_device(obj: Any, device: torch.device) -> Any:
    """An nn.Module, tensor, numpy array, or dict/list/tuple of them, on
    `device` (numpy arrays become tensors)."""
    if isinstance(obj, nn.Module):
        return obj.to(device).eval()
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj, device=device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # numpy has no bf16: widen to f32
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class TorchPredictor(Predictor):
    """Predictor over a (model, batch) -> predictions function.

    `model` is an nn.Module or a (nested) dict of parameter tensors; it is
    moved to `device` once. `predict` moves the batch's arrays to the same
    device, runs `apply_fn` under inference mode and returns numpy.
    """

    def __init__(self, model: Any, apply_fn: Callable[[Any, Any], Any], *,
                 device="cuda"):
        self._device = torch.device(device)
        self._model = _to_device(model, self._device)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable[[Any, Any], Any],
                        device="cuda") -> "TorchPredictor":
        state = checkpoint.to_dict()
        model = state.get("params", state)
        return cls(model, apply_fn, device=device)

    def predict(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        with torch.inference_mode():
            out = self._apply(self._model, _to_device(dict(batch), self._device))
        if not isinstance(out, dict):
            out = {"predictions": out}
        return {k: _to_numpy(v) for k, v in out.items()}


class _PredictorWorker:
    """map_batches callable class: constructs the predictor once per actor."""

    def __init__(self, predictor_cls, checkpoint, predictor_kwargs,
                 keep_columns):
        self._predictor = predictor_cls.from_checkpoint(
            checkpoint, **predictor_kwargs
        )
        self._keep = keep_columns

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = self._predictor.predict(batch)
        for col in self._keep:
            if col in batch and col not in out:
                out[col] = batch[col]
        return out


class BatchPredictor:
    """Run a Predictor over a Dataset (parity: train/batch_predictor.py).

    predict() maps the checkpointed model over the dataset's blocks on an
    actor pool (model loaded once per worker), returning a new Dataset of
    prediction batches. The actors hold one GPU each when the predictor
    runs on a card: `predictor_kwargs["device"]`, "cuda" when not given
    (TorchPredictor's default).
    """

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(
        self,
        dataset,
        *,
        batch_size: Optional[int] = None,
        num_workers: int = 2,
        keep_columns: tuple = (),
    ):
        from ray_tpu_torch.data.executor import ActorPoolStrategy

        device = torch.device(self._predictor_kwargs.get("device", "cuda"))
        return dataset.map_batches(
            _PredictorWorker,
            batch_size=batch_size,
            compute=ActorPoolStrategy(
                size=num_workers, num_gpus=1 if device.type == "cuda" else 0),
            fn_args=(self._predictor_cls, self._checkpoint,
                     self._predictor_kwargs, tuple(keep_columns)),
        )

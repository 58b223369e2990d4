"""Trainable: the unit of execution Tune schedules.

The port's copy of ray_tpu/tune/trainable.py (stdlib only): `Trainable`,
a class with setup/step/save/restore whose train() runs one iteration
(RLlib's Algorithm subclasses it), and `wrap_function`, which makes one
from a function trainable such as a trainer's `as_trainable()`. Tune's
controller (Tuner, trials, schedulers) waits for the multi-process
runtime (ROADMAP.md Queue A).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, Optional


class Trainable:
    """Subclass API: override setup(), step(), save_checkpoint(), load_checkpoint()."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self._iteration = 0
        self._time_total = 0.0
        self._timesteps_total = 0
        self.setup(self.config)

    # -- subclass hooks ----------------------------------------------------- #
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict[str, Any]]:
        """Write state into checkpoint_dir; optionally return a small dict
        stored alongside (both are delivered back to load_checkpoint)."""
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """In-place hyperparameter update (PBT exploit path). Return True if
        handled; False makes the caller restart the trainable."""
        return False

    def cleanup(self) -> None:
        pass

    # -- driver API --------------------------------------------------------- #
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        result = self.step() or {}
        dt = time.perf_counter() - t0
        self._iteration += 1
        self._time_total += dt
        if "timesteps_this_iter" in result:
            self._timesteps_total += int(result["timesteps_this_iter"])
        result.setdefault("training_iteration", self._iteration)
        result.setdefault("timesteps_total", self._timesteps_total)
        result.setdefault("time_this_iter_s", dt)
        result.setdefault("time_total_s", self._time_total)
        return result

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(checkpoint_dir, exist_ok=True)
        extra = self.save_checkpoint(checkpoint_dir)
        meta = {
            "iteration": self._iteration,
            "time_total": self._time_total,
            "timesteps_total": self._timesteps_total,
            "extra": extra,
        }
        with open(os.path.join(checkpoint_dir, "trainable_meta.pkl"), "wb") as f:
            pickle.dump(meta, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "trainable_meta.pkl"), "rb") as f:
            meta = pickle.load(f)
        self._iteration = meta["iteration"]
        self._time_total = meta["time_total"]
        self._timesteps_total = meta["timesteps_total"]
        self.load_checkpoint(meta["extra"] if meta["extra"] is not None else checkpoint_dir)

    def stop(self) -> None:
        self.cleanup()

    @property
    def iteration(self) -> int:
        return self._iteration


def wrap_function(train_fn: Callable) -> type:
    """Build a Trainable class from a function trainable.

    The function receives (config) — or (config, checkpoint_dir) when it
    declares two parameters — and reports by returning a metrics dict (one
    iteration) or by yielding one per iteration (a generator).
    Parity: tune/trainable/function_trainable.py:287 — the reference runs the
    fn on a thread and pumps a queue; we run it step-wise for determinism.
    """
    import inspect

    class FunctionTrainable(Trainable):
        _fn = staticmethod(train_fn)

        def setup(self, config):
            self._gen = None
            self._last_checkpoint_state = None

        def _make_gen(self, checkpoint_state=None):
            sig = inspect.signature(self._fn)
            if len(sig.parameters) >= 2:
                out = self._fn(self.config, checkpoint_state)
            else:
                out = self._fn(self.config)
            return out

        def step(self):
            if self._gen is None:
                out = self._make_gen(self._last_checkpoint_state)
                if inspect.isgenerator(out):
                    self._gen = out
                else:
                    self._final = dict(out or {})
                    self._final.setdefault("done", True)
                    return self._final
            try:
                return dict(next(self._gen))
            except StopIteration:
                return {"done": True}

        def save_checkpoint(self, checkpoint_dir):
            return {"state": self._last_checkpoint_state}

        def load_checkpoint(self, checkpoint):
            if isinstance(checkpoint, dict):
                self._last_checkpoint_state = checkpoint.get("state")

    FunctionTrainable.__name__ = getattr(train_fn, "__name__", "fn") + "_trainable"
    return FunctionTrainable

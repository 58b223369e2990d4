"""Trainable: the unit of execution Tune schedules.

The port's copy of ray_tpu/tune/trainable.py's `Trainable` (stdlib only):
a class with setup/step/save/restore whose train() runs one iteration.
RLlib's Algorithm subclasses it. `wrap_function` and Tune itself wait for
the runtime planes (ROADMAP.md Queue A item 5).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Dict, Optional


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

"""Checkpoint: a handle convertible between a dict and a directory.

Counterpart of ray_tpu/train/checkpoint.py (dict and directory forms). The
directory form stores the dict with torch.save, so tensors keep their dtype
and device (map_location moves them on load). `from_torch` / `to_torch`
take the place of orbax's `from_jax` / `to_jax`: a tree of tensors (nested
dicts and lists, with ints, floats and other picklable leaves beside them)
is stored with torch.distributed.checkpoint in a `torch_state`
subdirectory, and restored in place into a target's tensors, on the
target's devices, as orbax restores onto a target's shardings. Without a
process group DCP saves and loads in this one process; with one, every
rank of the group takes part, as with orbax across hosts.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

_PAYLOAD = "_dict_payload.pt"
_TORCH_STATE = "torch_state"


def _load_untargeted(ckpt_dir: str) -> Any:
    """The saved tree, tensors on the CPU, dict keys as strings (DCP keeps
    none of their types)."""
    from torch.distributed.checkpoint.state_dict_loader import (
        _load_state_dict_from_keys,
    )

    return _load_state_dict_from_keys(checkpoint_id=ckpt_dir)


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("exactly one of data= or path= required")
        self._data = data
        self._path = path

    # ------------------------------------------------------------- factories
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=data)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    @classmethod
    def from_torch(cls, tree: Any, path: Optional[str] = None) -> "Checkpoint":
        """Save a tree of tensors (a dict at the top; its tensors on any
        device) with torch.distributed.checkpoint."""
        import torch.distributed.checkpoint as dcp

        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        ckpt_dir = os.path.join(os.path.abspath(path), _TORCH_STATE)
        dcp.save(tree, checkpoint_id=ckpt_dir)
        return cls(path=path)

    # ----------------------------------------------------------- conversions
    def to_dict(self, map_location=None) -> Dict[str, Any]:
        """The checkpoint's dict. A directory checkpoint is loaded with
        torch.load (only open directories this program wrote: loading a
        pickle can run code)."""
        if self._data is not None:
            return self._data
        payload = os.path.join(self._path, _PAYLOAD)
        if not os.path.exists(payload):
            raise ValueError("directory checkpoint has no dict payload")
        return torch.load(payload, map_location=map_location, weights_only=False)

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._path is not None:
            if path and os.path.abspath(path) != os.path.abspath(self._path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
                return path
            return self._path
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        torch.save(self._data, os.path.join(path, _PAYLOAD))
        return path

    def to_torch(self, target: Any = None) -> Any:
        """Restore a from_torch tree. With `target` (a tree of the saved
        structure, e.g. a freshly initialized train state), the saved values
        are loaded in place into the target's tensors, on their devices, and
        its other leaves are replaced; the target is returned. Without one,
        the saved tree (on the CPU) is returned."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.api import CheckpointException

        if self._path is None:
            raise ValueError("to_torch requires a directory checkpoint")
        ckpt_dir = os.path.join(os.path.abspath(self._path), _TORCH_STATE)
        if target is not None:
            try:
                dcp.load(target, checkpoint_id=ckpt_dir)
                return target
            # DCP raises CheckpointException, a BaseException
            except (Exception, CheckpointException) as targeted_err:  # noqa: BLE001
                # Fall back to an untargeted restore ONLY for a structure
                # mismatch (checkpoint wraps params under extra keys — caller
                # unpacks). A genuinely corrupt/unreadable checkpoint fails
                # both ways; surface the original error then instead of a
                # confusing downstream shape error.
                try:
                    restored = _load_untargeted(ckpt_dir)
                except (Exception, CheckpointException):
                    raise targeted_err
                logging.getLogger(__name__).warning(
                    "targeted checkpoint restore failed (%s); restored saved "
                    "structure WITHOUT the target's devices",
                    targeted_err,
                )
                return restored
        return _load_untargeted(ckpt_dir)

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._path}"
        return f"Checkpoint({kind})"

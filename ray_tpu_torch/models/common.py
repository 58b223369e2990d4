"""What the port's models share: parameter trees from the JAX package, the
layer loop over stacked parameters, the remat policies and the dispatch of
causal attention.

A model's parameters are a nested dict of tensors in the JAX package's
layout, with every block parameter stacked on a leading layer axis.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import flash_attention, plain_causal_attention
from ray_tpu_torch.ops.gathered_attention import gathered_attention
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.mesh import (
    axis_size, current_mesh, sums_of_copies, use_mesh,
)


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch twin in numpy
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    # copy: jax.device_get hands out read-only arrays
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """A JAX parameter tree (dicts and lists of numpy arrays, or anything
    np.asarray takes) → the same tree of torch tensors, names, shapes and
    dtypes unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def _parameter_dict(tree: Dict[str, Any]) -> nn.ParameterDict:
    """A nested dict of tensors as nested ParameterDicts (a sub-dict, such as
    GPT-2's blocks["moe"], becomes a submodule)."""
    return nn.ParameterDict({
        k: _parameter_dict(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()
    })


def _tree(params: nn.ParameterDict) -> Dict[str, Any]:
    return {k: _tree(v) if isinstance(v, nn.ParameterDict) else v
            for k, v in params.items()}


class ParamsModule(nn.Module):
    """An nn.Module over a model's parameter tree in the JAX layout: the
    top-level tensors and the stacked block tensors (nested where the tree
    nests, as MoE blocks do) as ParameterDicts. A model's module adds
    `forward`."""

    def __init__(self, cfg, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.top = _parameter_dict(
            {k: v for k, v in params.items() if k != "blocks"})
        self.blocks = _parameter_dict(params["blocks"])

    def params(self) -> Dict[str, Any]:
        return {**_tree(self.top), "blocks": _tree(self.blocks)}


def layers(blocks: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """One (nested) dict of views per layer of the stacked block
    parameters. unbind: one stack of the layers' gradients per leaf in the
    backward (indexing w[i] would add a zero-filled [L, ...] per layer)."""
    per_key = {k: list(layers(v)) if isinstance(v, dict) else v.unbind(0)
               for k, v in blocks.items()}
    for layer in zip(*per_key.values()):
        yield dict(zip(per_key.keys(), layer))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rerunnable(mesh, keeps_products: bool, block: Callable, *args):
    """block(*args) under `mesh`; where the checkpoint keeps the products'
    outputs for the recompute, the tp sums take copies of them (an
    in-place sum would change what the recompute reads)."""
    with use_mesh(mesh), (sums_of_copies() if keeps_products
                          else contextlib.nullcontext()):
        return block(*args)


def run_block(block: Callable, remat: Any, *args):
    """block(*args) under a remat policy: True checkpoints the block (its
    activations are recomputed in the backward), "dots" saves only the
    matrix products' outputs (as jax.checkpoint_policies.checkpoint_dots
    does), False saves everything. A checkpointed block's backward runs it
    again under the mesh (parallel/mesh.py) it ran under here, on whatever
    thread the autograd engine runs it."""
    if not remat or not torch.is_grad_enabled():
        return block(*args)
    block = partial(_rerunnable, current_mesh(), remat == "dots", block)
    if remat == "dots":
        return checkpoint(
            block, *args, use_reentrant=False,
            context_fn=partial(create_selective_checkpoint_contexts, _save_dots),
        )
    return checkpoint(block, *args, use_reentrant=False)


def attention_path(impl: str, cp: Optional[int]) -> str:
    """Which path a model's attention (`attention_impl`) takes under a mesh
    whose cp axis has `cp` ranks (None: no mesh):
    - "ring": ring attention over the mesh's cp axis
      (ops/ring_attention.py), for "ring" under any mesh (a cp group of one
      included) and "auto" under cp > 1; "ring" without a mesh raises;
    - "gathered": "pallas" and "xla" under any mesh, k and v gathered over
      cp (ops/gathered_attention.py), as the reference's GSPMD gathers them;
    - "flash": "auto" and "pallas" without a mesh, "auto" under cp 1;
    - "plain": "xla" without a mesh."""
    if impl == "ring":
        if cp is None:
            raise ValueError(
                "attention_impl='ring' needs a mesh with a cp axis; call the "
                "model inside parallel.mesh.use_mesh(mesh) (train_step does)")
        return "ring"
    if cp is None:
        return "plain" if impl == "xla" else "flash"
    if impl == "auto":
        return "ring" if cp > 1 else "flash"
    return "gathered"


def causal_attention(q, k, v, impl: str):
    """q [B, H, S, hd], k and v [B, KH, S, hd] (H a multiple of KH; under
    cp, this rank's chunk of the sequence) → [B, H, S, hd], causal, by the
    path `attention_path` names. Grouped-query kv heads are repeated in
    place (h0, h0, h1, h1: as `jnp.repeat`) to q's head count before the
    attention, and after the gather on the gathered path."""
    mesh = current_mesh()
    path = attention_path(impl, None if mesh is None else axis_size(mesh, ("cp",)))
    if path == "gathered":
        return gathered_attention(q, k, v, mesh, impl=impl)
    groups = q.shape[1] // k.shape[1]
    if groups > 1:
        k, v = (x.repeat_interleave(groups, dim=1) for x in (k, v))
    if path == "ring":
        return ring_attention(q, k, v, mesh, causal=True)
    if path == "flash":
        return flash_attention(q, k, v, causal=True, layout="bhsd")
    return plain_causal_attention(q, k, v)

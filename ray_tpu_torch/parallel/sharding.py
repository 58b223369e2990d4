"""Logical-axis sharding rules (counterpart of ray_tpu/parallel/sharding.py).

A model names each parameter dimension with a logical axis ("vocab",
"embed", "expert", ...); a rule table maps those to mesh axes. The
reference turns the table into PartitionSpecs and lets XLA move the data;
here it becomes one DTensor placement per mesh dimension, and the state of
a meshed train step holds each parameter as a DTensor with those
placements over its DeviceMesh (its local shard is what the optimizer
updates). The model computes on `working_tree`'s local tensors: each shard
gathered over the batch axes, still split over tp, ep and pp.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, BATCH_AXES, gather_dims

# logical axis → mesh axis (or tuple of mesh axes). None = replicated.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "cp",
    "layers": None,          # pipelined plans override this to "pp" (the
                             # train step does it) so that each stage holds
                             # only its own layers
    "vocab": "tp",
    "embed": "fsdp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "expert": "ep",
    "stage": "pp",
}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def partition_spec(logical_axes: Sequence[Optional[str]],
                   rules: Optional[Dict] = None) -> Tuple[Any, ...]:
    """Per tensor dim, the mesh axis (or tuple of axes, or None) its logical
    axis maps to: the reference's PartitionSpec as a tuple."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return tuple(None if ax is None else rules.get(ax) for ax in logical_axes)


def spec_for(logical_axes: Sequence[Optional[str]], rules: Optional[Dict] = None):
    """One placement per mesh dim (AXIS_ORDER): Shard(i) on the mesh dims
    that tensor dim i's rule names, Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * len(AXIS_ORDER)
    for i, target in enumerate(partition_spec(logical_axes, rules)):
        for a in (target,) if isinstance(target, str) else (target or ()):
            if not isinstance(placements[AXIS_ORDER.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{tuple(logical_axes)}")
            placements[AXIS_ORDER.index(a)] = Shard(i)
    return tuple(placements)


def tree_specs(logical_tree: Any, rules: Optional[Dict] = None) -> Any:
    """spec_for over a (nested) dict of logical-axis tuples."""
    if _is_axes(logical_tree):
        return spec_for(logical_tree, rules)
    return {k: tree_specs(v, rules) for k, v in logical_tree.items()}


def shard_tree(mesh, tree: Any, logical_tree: Any, rules=None) -> Any:
    """Place a (nested) dict of full tensors on `mesh`: each leaf becomes a
    DTensor with its placements from the rule table, holding on this rank
    its shard (rank 0's values, scattered). A sharded dim must divide by its
    mesh axes' sizes, as the reference requires."""
    from torch.distributed.tensor import Shard, distribute_tensor

    if _is_axes(logical_tree):
        placements = spec_for(logical_tree, rules)
        for a, p in zip(AXIS_ORDER, placements):
            n = mesh.size(AXIS_ORDER.index(a))
            if isinstance(p, Shard) and tree.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} ({logical_tree[p.dim]!r}) of a "
                    f"{tuple(tree.shape)} parameter ({tuple(logical_tree)}) "
                    f"not divisible by {a}={n}")
        with torch.no_grad():
            return distribute_tensor(tree.detach(), mesh, placements)
    return {k: shard_tree(mesh, v, logical_tree[k], rules) for k, v in tree.items()}


def gather_tree(tree: Any) -> Any:
    """Copies of the full tensors of a (nested) dict of DTensors, on every
    rank."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        # the shard the optimizer updates requires grad: gather a detached
        # view of it; full_tensor may hand back that view itself (a replica)
        local = DTensor.from_local(
            tree.to_local().detach(), tree.device_mesh, tree.placements,
            run_check=False, shape=tree.shape, stride=tree.stride())
        return local.full_tensor().clone()


def batch_gather_dims(placements) -> list:
    """The (batch axis, dim) pairs that shard a tensor of these placements,
    in mesh order: what `working_tree` gathers it over."""
    from torch.distributed.tensor import Shard

    return [(a, p.dim) for a, p in zip(AXIS_ORDER, placements)
            if a in BATCH_AXES and isinstance(p, Shard)]


def working_tree(tree: Any) -> Any:
    """This rank's working copy of a (nested) dict of DTensors, the tensors
    the model computes on: each local shard gathered over the batch axes
    (dp, fsdp) that shard it, still split over tp, ep and pp. Detached
    local tensors; the meshed train step and a meshed forward both use it."""
    if isinstance(tree, dict):
        return {k: working_tree(v) for k, v in tree.items()}
    with torch.no_grad():
        local = tree.to_local().detach()
    return gather_dims(local, tree.device_mesh, batch_gather_dims(tree.placements))

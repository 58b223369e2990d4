"""Device mesh over torch.distributed (counterpart of ray_tpu/parallel/mesh.py).

The reference names six mesh axes and lets XLA place the collectives. Here
the mesh is a `torch.distributed.device_mesh.DeviceMesh` with the same six
named dimensions, every one kept even at size 1, and the collectives are
explicit: the helpers below run one over each named axis in turn, on the
process group of that mesh dimension.

  dp    pure data parallelism (params replicated)
  fsdp  data parallelism with params sharded (gathered for the step,
        gradients reduce-scattered)
  pp    pipeline stages (parallel/pipeline.py)
  tp    tensor parallelism (Megatron style, parallel/tensor.py): each rank
        holds H/tp heads, F/tp MLP columns and V/tp vocabulary rows
  cp    context parallelism (ring attention): not ported yet
  ep    expert parallelism: each rank holds E/ep experts of every MoE layer

A global batch is split over (dp, fsdp) in mesh order, so the ranks of one
ep, tp or pp group hold the same rows.

Every collective the helpers below run is counted, per mesh axis, in
`collectives` (a Counter the tests and chip_smoke.py read and clear), as
the flash wrappers count their launches.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Outermost → innermost.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "ep", "cp", "tp")

# Axes over which a global batch is split.
BATCH_AXES: Tuple[str, ...] = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Unspecified axes default to size 1."""

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    cp: int = 1
    tp: int = 1

    @property
    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        n = 1
        for v in self.sizes.values():
            n *= v
        return n

    def batch_size_divisor(self) -> int:
        return self.dp * self.fsdp

    @staticmethod
    def for_devices(n: int, *, tp: int = 1, pp: int = 1, cp: int = 1, ep: int = 1,
                    fsdp: Optional[int] = None) -> "MeshSpec":
        """Fill the data axes with whatever devices remain after model axes."""
        model = tp * pp * cp * ep
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by tp*pp*cp*ep={model}")
        rest = n // model
        if fsdp is None:
            fsdp, dp = rest, 1
        else:
            if rest % fsdp:
                raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
            dp = rest // fsdp
        return MeshSpec(dp=dp, pp=pp, fsdp=fsdp, ep=ep, cp=cp, tp=tp)


def init_distributed(backend: str = "nccl", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: float = 300.0) -> None:
    """Start this process's default process group. Without `init_method`,
    rank, world size and rendezvous come from the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them); otherwise
    give them, e.g. init_method="file:///path/rdzv" or
    "tcp://localhost:<port>". A collective that waits longer than
    `timeout_s` fails instead of hanging. With NCCL, the process's CUDA
    device is LOCAL_RANK (else the rank) modulo the visible devices."""
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def make_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """The DeviceMesh of `spec` over every rank of the default process group
    (which init_distributed starts), dims named AXIS_ORDER, size-1 dims
    kept."""
    from torch.distributed.device_mesh import init_device_mesh

    n = spec.num_devices
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(
            f"MeshSpec needs {n} ranks, the process group has {have}")
    shape = tuple(spec.sizes[a] for a in AXIS_ORDER)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device_type: str = "cuda"):
    return make_mesh(MeshSpec(), device_type)


def mesh_spec(mesh) -> MeshSpec:
    """The MeshSpec a mesh was made from."""
    return MeshSpec(**{a: mesh.size(i) for i, a in enumerate(AXIS_ORDER)})


def axis_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(AXIS_ORDER.index(a))
    return n


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index along `axes` taken together, in mesh order."""
    i = 0
    for a in axes:
        i = i * mesh.size(AXIS_ORDER.index(a)) + mesh.get_local_rank(a)
    return i


def local_rows(mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch: split over (dp, fsdp) in mesh
    order, contiguous, as the reference's data sharding lays them out. The
    sequence is not split (no cp yet)."""
    n = axis_size(mesh, BATCH_AXES)
    if batch_size % n:
        raise ValueError(
            f"global batch {batch_size} not divisible by dp*fsdp={n}")
    per = batch_size // n
    start = axis_index(mesh, BATCH_AXES) * per
    return slice(start, start + per)


def local_batch(mesh, batch: Dict[str, object]) -> Dict[str, object]:
    """This rank's rows of each [B, ...] array of a global batch."""
    rows = local_rows(mesh, len(batch["tokens"]))
    return {k: v[rows] for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Collectives over named axes: one per axis, on that dimension's group
# --------------------------------------------------------------------------- #

# collectives run by the helpers below since the last clear(), by mesh axis
collectives: collections.Counter = collections.Counter()


def _group(mesh, a: str):
    collectives[a] += 1
    return mesh.get_group(a)


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `t` in place (a sum, or `op`) over the ranks of `axes`;
    returns it."""
    for a in axes:
        dist.all_reduce(t, op=op, group=_group(mesh, a))
    return t


def all_reduce_max(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise max of `t` over the ranks of `axes`, in place."""
    return all_reduce(t, mesh, axes, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """[n, *t.shape]: `t` of every rank of `axes`, in mesh order (n is the
    product of their sizes)."""
    out = t.contiguous()[None]
    for a in reversed(axes):        # innermost first
        parts = [torch.empty_like(out) for _ in range(mesh.size(AXIS_ORDER.index(a)))]
        dist.all_gather(parts, out, group=_group(mesh, a))
        out = torch.cat(parts)
    return out


def gather_dims(t: torch.Tensor, mesh, dims: Sequence[Tuple[str, int]]) -> torch.Tensor:
    """`t`, a shard split over each (axis, dim) of `dims` (in mesh order),
    with every rank's shard put back in its place along its dim."""
    for a, dim in reversed(dims):   # innermost first
        parts = [torch.empty_like(t) for _ in range(axis_size(mesh, (a,)))]
        dist.all_gather(parts, t.contiguous(), group=_group(mesh, a))
        t = torch.cat(parts, dim)
    return t


def reduce_scatter_dims(t: torch.Tensor, mesh,
                        dims: Sequence[Tuple[str, int]]) -> torch.Tensor:
    """The inverse of gather_dims for a sum: `t` summed over the ranks of
    each (axis, dim) of `dims`, each rank keeping its own shard of it."""
    for a, dim in dims:             # outermost first
        chunks = [c.contiguous() for c in t.chunk(axis_size(mesh, (a,)), dim)]
        t = torch.empty_like(chunks[0])
        dist.reduce_scatter(t, chunks, group=_group(mesh, a))
    return t


def broadcast(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """`t` of the first rank of each of `axes`, in place."""
    for a in axes:
        group = _group(mesh, a)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        if getattr(_local, "copy_sums", False):
            t = t.clone()
        else:
            ctx.mark_dirty(t)
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


def sum_over(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of `t` over the ranks of `axes`, differentiable. Every rank of
    the group goes on with the same sum into the same computation, so the
    backward hands each rank the gradient of its one copy (not the sum over
    the copies, which would count it once per rank). `t` is summed in
    place (under `sums_of_copies`, a copy of it): give it a fresh tensor
    that nothing else reads (a product's output, as every caller does)."""
    return _SumOver.apply(t, mesh, tuple(axes))


def copy_over(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """`t`, whose gradient is summed over the ranks of `axes`: for a value
    that every rank holds whole but each rank uses for its own share of a
    sum (its experts' inputs and gates, a column-parallel product's
    input). The incoming gradient is summed in place, as Megatron's f sums
    it: the result must feed products, each of whose backward makes a
    gradient of its own, not a sum that would hand the same one on."""
    return _CopyOver.apply(t, mesh, tuple(axes))


# The mesh the model runs under: model code that needs it (the MoE layer's
# global capacity and expert shards, GPT-2's pipeline, the tensor-parallel
# products) reads it here; the train step enters it around the forward and
# backward. Per thread: on the card the autograd engine runs the backward
# on a thread of its own, so code that runs the forward again there takes
# the mesh it ran under along: a checkpointed block enters it
# (models/common.py's `run_block`), a chunk of GPT-2's loss is given it.
_local = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh():
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def sums_of_copies():
    """Within, on this thread, sum_over sums a copy of its input and leaves
    the input as it was: for code that keeps the products it sums (a
    selective checkpoint that saves them for its recompute)."""
    prev = getattr(_local, "copy_sums", False)
    _local.copy_sums = True
    try:
        yield
    finally:
        _local.copy_sums = prev

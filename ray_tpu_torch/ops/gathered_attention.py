"""Gathered attention: causal attention over a sequence split across the
mesh's cp axis, by gathering k and v.

The port's counterpart of what GSPMD does with the reference's "pallas"
and "xla" attention (ray_tpu/models/gpt2.py and llama.py) on a mesh whose
cp axis shards the sequence: the model computes attention over the whole
sequence as if it were not split, and XLA's partitioner gathers k and v
over cp while q, and so the output, stay split. Here that is written out:

- forward: this rank's k and v chunks [B, KH, S/cp, hd] are stacked and
  all-gathered over the cp group along the sequence (one collective for
  both) into [B, KH, S, hd]; grouped-query kv heads are repeated to q's
  head count only after the gather, so 1/groups of the bytes move; then
  this rank's q chunk [B, H, S/cp, hd], at its GLOBAL offset c·S/cp,
  attends to the whole k and v: "pallas" through the flash kernels
  (ops/attention.py's `_FlashAttention` at that q offset: the Hopper
  kernels on the card, their plain versions on the CPU), "xla" through
  the plain einsum path with the offset mask (`plain_causal_attention`);
- backward: the attention's backward gives dq of the local chunk and this
  rank's partial dk and dv over the whole sequence, in the input dtype;
  the gather's backward (`_GatherSequence`) sums those over the cp group
  in f32 and hands each rank its own chunk (a reduce-scatter), cast back
  once: the ring's rounding rule (ops/ring_attention.py).

A cp group of one runs the same code: its gather and reduce-scatter are
collectives on a group of one, counted in parallel.mesh.collectives["cp"]
like any other (two a call; three where a checkpointed block runs its
forward again).

`virtual_gathered_attention` runs the same over a list of cp chunks held
by this one process, with no group (as `virtual_ring_attention` does):
chunk r's queries attend to the joined k and v at offset r·S/cp, and the
chunks' partial dk and dv are summed in f32 before the split. The tests and
chip_smoke.py use it. With "pallas" each kernel launches once a chunk a
call: cp forward and cp backward launches over cp chunks.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ray_tpu_torch.ops.attention import (
    _FlashAttention, _default_scale, plain_causal_attention,
)
from ray_tpu_torch.parallel.mesh import gather_dims, reduce_scatter_dims

IMPLS = ("pallas", "xla")


class _GroupGather:
    """The mesh's cp process group: this process is cp rank r and holds
    one chunk."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.ranks = [mesh.get_local_rank("cp")]

    def gather(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = chunks
        return [gather_dims(x, self.mesh, [("cp", x.dim() - 2)])]

    def scatter(self, full: torch.Tensor) -> List[torch.Tensor]:
        return [reduce_scatter_dims(full, self.mesh, [("cp", full.dim() - 2)])]


class _VirtualGather:
    """n chunks held by this one process: each gets its own copy of the
    joined tensor, so that autograd hands back each chunk's partial
    gradient apart."""

    def __init__(self, n: int):
        self.ranks = list(range(n))

    def gather(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        full = torch.cat(list(chunks), chunks[0].dim() - 2)
        return [full] + [full.clone() for _ in chunks[1:]]

    def scatter(self, full: torch.Tensor) -> List[torch.Tensor]:
        return list(full.chunk(len(self.ranks), full.dim() - 2))


class _GatherSequence(torch.autograd.Function):
    """The sequence chunks of every rank of `group` joined along the
    second-to-last dim, one copy for each chunk this process holds; the
    backward sums the copies' gradients over the group in f32 and hands
    each chunk its part, cast to the chunk's dtype."""

    @staticmethod
    def forward(ctx, group, *chunks):
        ctx.group, ctx.dtype = group, chunks[0].dtype
        return tuple(group.gather([c.contiguous() for c in chunks]))

    @staticmethod
    def backward(ctx, *grads):
        total = sum(g.float() for g in grads)
        return (None, *(p.to(ctx.dtype) for p in ctx.group.scatter(total)))


def _attend(q, k, v, impl: str, q_offset: int) -> torch.Tensor:
    if impl == "pallas":
        q, k, v = (x.contiguous() for x in (q, k, v))
        return _FlashAttention.apply(q, k, v, True, _default_scale(q, None),
                                     q_offset)
    return plain_causal_attention(q, k, v, q_offset)


def _gathered(group, qs, ks, vs, impl: str) -> List[torch.Tensor]:
    if impl not in IMPLS:
        raise ValueError(f"gathered attention runs {IMPLS}, not {impl!r}")
    S, groups = qs[0].shape[2], qs[0].shape[1] // ks[0].shape[1]
    kvs = _GatherSequence.apply(group, *(torch.stack([k, v]) for k, v in zip(ks, vs)))
    outs = []
    for r, q, kv in zip(group.ranks, qs, kvs):
        k, v = kv.unbind(0)
        if groups > 1:
            k, v = (x.repeat_interleave(groups, dim=1) for x in (k, v))
        outs.append(_attend(q, k, v, impl, r * S))
    return outs


def gathered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh, *, impl: str = "pallas") -> torch.Tensor:
    """Causal attention of this rank's sequence chunk over the mesh's cp
    group (module docstring): q [B, H, S_local, hd], k and v
    [B, KH, S_local, hd] (H a multiple of KH), chunk c of the group
    holding global positions [c·S_local, (c + 1)·S_local) → this rank's
    output [B, H, S_local, hd], differentiable. Every rank of the group
    must call it, with equal chunk lengths."""
    (o,) = _gathered(_GroupGather(mesh), [q], [k], [v], impl)
    return o


def virtual_gathered_attention(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor], *, impl: str = "pallas",
) -> List[torch.Tensor]:
    """gathered_attention over cp chunks held by this one process, with no
    group: qs[r] [B, H, S, hd], ks[r] and vs[r] [B, KH, S, hd] are chunk r,
    at global positions [r·S, (r + 1)·S) → each chunk's output,
    differentiable."""
    if not len(qs) == len(ks) == len(vs) >= 1:
        raise ValueError("virtual gather: one q, k and v chunk for each rank")
    return _gathered(_VirtualGather(len(qs)), list(qs), list(ks), list(vs), impl)

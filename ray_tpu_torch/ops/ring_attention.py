"""Ring attention: exact attention over a context-parallel (cp) mesh axis.

Counterpart of ray_tpu/ops/ring_attention.py. Each rank of a cp group
holds a contiguous S/cp slice of the sequence; its queries stay put while
the k and v chunks rotate one rank on per step, so that after cp steps
every query has met every kv chunk. A step runs the flash kernels of
ops/attention.py (the Hopper kernels on the card, their plain versions on
the CPU) on one (q chunk, kv chunk) pair at its GLOBAL offsets
(q_offset = r·S, kv_offset = src·S, S the chunk length), and the partial
outputs are merged by their logsumexp (`_merge`). The reference rotates
with `lax.ppermute` inside a shard_map; here a rotation is one
`dist.batch_isend_irecv` on the mesh's cp process group (send to rank
r + 1, receive from r − 1), counted in parallel.mesh.collectives["cp"].
Everything stays in the kernels' [B, H, S, hd] layout; the reference goes
through [B, S, H, hd] at every chunk, which changes no number.

Backward (`_ring_backward`): k and v rotate a second time, and each
chunk's f32 dk and dv accumulators travel with it, so that after cp
rotations (the last one moves only dk and dv) each chunk's gradient is
back on its owner; dq is summed where it is. Each step's contributions
come from the backward kernel with the GLOBAL lse and delta =
rowsum(do·o) of the final output: flash attention's backward is exact
over kv chunks.

Rounding follows the reference: each partial o comes back in q's dtype
and is cast to f32 for the merge; the merged o is cast to q's dtype once,
at the end; each step's dq, dk and dv come back in the input dtype and
are summed in f32; dk and dv travel in f32; the result is cast back once.

Overlap: each step's rotation is posted before that step's kernel and
waited on after it, so the transfer runs beside the chunk's work (NCCL
runs it on its own stream; XLA's async collective-permute does the same on
the TPU). In the backward only k and v can go early: dk and dv hold this
step's contribution, so they travel after their chunk's kernel, and that
transfer is not hidden.

Two shortcuts, both exact:
- the accumulators start from the first step's result instead of a merge
  with the empty partial (o 0, lse −1e30): there exp(−1e30 − lse) = 0 and
  log 1 = 0, so the merge gives that result back unchanged, and the
  gradients' sums start from 0 + x = x. The first step's chunk is the
  rank's own, which always holds a visible key (its diagonal).
- under a causal mask a kv chunk wholly in the future of the rank's
  queries (src > r) is not launched: the kernel would give o 0 and
  lse −1e30, which the merge weighs 0 (exp(−1e30 − lse) = 0, log 1 = 0),
  and zero gradients, which leave the sums unchanged. Its rotation still
  runs: the next rank needs the chunk.
So cp rank r launches each kernel r + 1 times a call (forward and
backward alike), a virtual ring of cp chunks cp·(cp + 1)/2 times; without
a causal mask every rank launches cp times.

A ring over a group of one moves nothing (the rotation is the identity,
and gloo has no pair to itself): no exchange runs there, and none is
counted. `virtual_ring_attention` runs the same step schedule over a list
of cp chunks in one process, with no group (as pipeline_apply runs its
stages without one): the tests and the on-card smoke use it.

No zigzag (load-balanced) layout: the reference has none, so the last cp
rank does cp chunk pairs and the first one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (
    _default_scale, _mha_backward_bhsd, _mha_forward_bhsd,
)
from ray_tpu_torch.parallel import mesh as mesh_lib

Chunks = List[Tuple[torch.Tensor, ...]]


def _merge(o1, lse1, o2, lse2):
    """Combine two attention partials by logsumexp weights, in the
    reference's order of operations. o*: [B, H, S, hd] f32, lse*: [B, H, S]
    f32 → (o, lse)."""
    m = torch.maximum(lse1, lse2)
    e1 = torch.exp(lse1 - m)
    e2 = torch.exp(lse2 - m)
    denom = e1 + e2
    lse = m + torch.log(denom)
    w1 = (e1 / denom)[..., None]
    w2 = (e2 / denom)[..., None]
    return o1 * w1 + o2 * w2, lse


class _GroupRing:
    """The ring of a mesh's cp process group: this process is cp rank r
    and holds one chunk of each rotated tensor."""

    def __init__(self, mesh):
        self.group = mesh.get_group("cp")
        self.n = dist.get_world_size(self.group)
        self.ranks = [dist.get_rank(self.group)]

    def shift(self, chunks: Chunks, tag: int,
              counted: bool = True) -> Callable[[], Chunks]:
        """Post the rotation of each of this rank's tensors to the next
        rank; returns the wait, which gives what the previous rank sent.
        Counted in collectives["cp"] unless `counted` is False (a part of
        a rotation counted with its other part)."""
        if self.n == 1:
            return lambda: chunks
        (tensors,) = chunks
        r = self.ranks[0]
        to = dist.get_global_rank(self.group, (r + 1) % self.n)
        frm = dist.get_global_rank(self.group, (r - 1) % self.n)
        outs = tuple(torch.empty_like(t) for t in tensors)
        ops = ([dist.P2POp(dist.isend, t.contiguous(), to, self.group, tag)
                for t in tensors]
               + [dist.P2POp(dist.irecv, o, frm, self.group, tag) for o in outs])
        reqs = dist.batch_isend_irecv(ops)
        if counted:
            mesh_lib.collectives["cp"] += 1

        def wait() -> Chunks:
            for req in reqs:
                req.wait()
            return [outs]
        return wait


class _VirtualRing:
    """A ring of n chunks held by this one process: rank r's chunk is
    entry r, and a rotation moves entry r to r + 1."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = list(range(n))

    def shift(self, chunks: Chunks, tag: int,
              counted: bool = True) -> Callable[[], Chunks]:
        rotated = [chunks[(i - 1) % self.n] for i in range(self.n)]
        return lambda: rotated


def _future(causal: bool, src: int, r: int) -> bool:
    """Whether kv chunk src is wholly in the causal future of rank r's
    queries (equal chunk lengths)."""
    return causal and src > r


def _ring_forward(ring, qs, ks, vs, causal: bool, scale: float):
    """The forward schedule: for each rank this process runs, (o f32,
    lse f32) over every kv chunk."""
    n, S = ring.n, qs[0].shape[2]
    kv: Chunks = list(zip(ks, vs))
    acc: list = [None] * len(ring.ranks)
    for step in range(n):
        # the rotation for the next step runs beside this step's kernels
        pending = ring.shift(kv, tag=0) if step != n - 1 else None
        for i, r in enumerate(ring.ranks):
            src = (r - step) % n      # the chunk held: rotated `step` times
            if _future(causal, src, r):
                continue
            o_c, lse_c = _mha_forward_bhsd(qs[i], *kv[i], r * S, src * S,
                                           causal=causal, scale=scale)
            acc[i] = ((o_c.float(), lse_c) if step == 0
                      else _merge(*acc[i], o_c.float(), lse_c))
        if pending is not None:
            kv = pending()
    return acc


def _ring_backward(ring, qs, ks, vs, os_, lses, dos, causal: bool,
                   scale: float):
    """The backward schedule: (dq, dk, dv) in the inputs' dtypes for each
    rank this process runs."""
    n, S = ring.n, qs[0].shape[2]
    kv: Chunks = list(zip(ks, vs))
    dq: list = [None] * len(ring.ranks)
    dkv: Chunks = [None] * len(ring.ranks)   # travel with their kv chunk
    for step in range(n):
        # k and v go ahead of this step's kernels; with dk and dv after
        # them they make one rotation, counted once
        pending = (ring.shift(kv, tag=0, counted=False) if step != n - 1
                   else None)
        for i, r in enumerate(ring.ranks):
            src = (r - step) % n
            if _future(causal, src, r):
                continue
            dq_c, dk_c, dv_c = _mha_backward_bhsd(
                qs[i], *kv[i], os_[i], lses[i], dos[i], r * S, src * S,
                causal=causal, scale=scale)
            if step == 0:
                dq[i], dkv[i] = dq_c.float(), (dk_c.float(), dv_c.float())
            else:
                dq[i] = dq[i] + dq_c.float()
                dkv[i] = (dkv[i][0] + dk_c.float(), dkv[i][1] + dv_c.float())
        # dk and dv hold this step's contribution: they go only now; the
        # last rotation brings each chunk's gradient home
        dkv = ring.shift(dkv, tag=1)()
        if pending is not None:
            kv = pending()
    return [(g.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
            for g, (dk, dv), q, k, v in zip(dq, dkv, qs, ks, vs)]


class _RingAttention(torch.autograd.Function):
    """Ring attention over `ring` (a _GroupRing or a _VirtualRing): the
    tensors are this process's q, then k, then v chunks, one per rank it
    runs, each [B, H, S, hd]; returns their outputs."""

    @staticmethod
    def forward(ctx, ring, causal: bool, scale: float, *qkv):
        m = len(qkv) // 3
        qs, ks, vs = qkv[:m], qkv[m:2 * m], qkv[2 * m:]
        acc = _ring_forward(ring, qs, ks, vs, causal, scale)
        outs = tuple(o.to(q.dtype) for (o, _), q in zip(acc, qs))
        ctx.save_for_backward(*qkv, *outs, *(lse for _, lse in acc))
        ctx.ring, ctx.causal, ctx.scale, ctx.m = ring, causal, scale, m
        return outs

    @staticmethod
    def backward(ctx, *dos):
        m, saved = ctx.m, ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * m:(i + 1) * m] for i in range(5))
        grads = _ring_backward(ctx.ring, qs, ks, vs, outs, lses,
                               [d.contiguous() for d in dos], ctx.causal,
                               ctx.scale)
        return (None, None, None, *(g[0] for g in grads),
                *(g[1] for g in grads), *(g[2] for g in grads))


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention over `mesh`'s cp process group (module docstring).
    q, k, v: this rank's sequence chunk [B, H, S_local, hd], chunk r of the
    cp group holding global positions [r·S_local, (r + 1)·S_local) →
    this rank's output [B, H, S_local, hd], differentiable. Every rank of
    the group must call it, with equal chunk lengths."""
    scale = _default_scale(q, scale)
    (o,) = _RingAttention.apply(_GroupRing(mesh), causal, scale,
                                q.contiguous(), k.contiguous(), v.contiguous())
    return o


def virtual_ring_attention(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor], *, causal: bool = True,
    scale: Optional[float] = None,
) -> List[torch.Tensor]:
    """The ring's step schedule over cp chunks held by this one process,
    with no group: qs[r], ks[r], vs[r] are chunk r, [B, H, S, hd] each, at
    global positions [r·S, (r + 1)·S) → each chunk's output, differentiable
    (module docstring)."""
    if not len(qs) == len(ks) == len(vs) >= 1:
        raise ValueError("virtual ring: one q, k and v chunk for each rank")
    scale = _default_scale(qs[0], scale)
    outs = _RingAttention.apply(_VirtualRing(len(qs)), causal, scale,
                                *(x.contiguous() for x in (*qs, *ks, *vs)))
    return list(outs)

"""Masked softmax cross-entropy with a lean backward (autograd.Function).

Counterpart of ray_tpu/ops/cross_entropy.py::softmax_xent, an XLA
composition there and plain PyTorch here (no hand-written kernel: the
reference has no Pallas kernel for it). What it keeps from the reference
is the backward's residuals: only the logits as given (bf16 on the model's
path), a [...] f32 logsumexp and the targets — never a full-vocabulary f32
log-probability tensor.

- forward: f32 max-subtracted logsumexp and a one-hot pick of the target's
  shifted logit;
- backward: (softmax − onehot)·g, cast to the logits' dtype.

Ignore index: any target < 0 gives 0 loss and 0 gradient.

`vocab_parallel_xent` is the same function of logits split over the
vocabulary across the ranks of the mesh's tp axis (parallel/tensor.py),
the reference's `softmax_xent` under vocab sharding: each rank holds
[..., V/tp] of them and never gathers the rest.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.mesh import all_reduce, all_reduce_max
from ray_tpu_torch.parallel.tensor import TP, vocab_range


class _SoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        shifted = logits.to(torch.float32, copy=True)  # f32 work in place
        m = shifted.amax(dim=-1)
        shifted.sub_(m[..., None])
        sumexp = torch.exp(shifted).sum(dim=-1)
        valid = targets >= 0
        safe = torch.where(valid, targets, torch.zeros_like(targets))
        picked = shifted.gather(-1, safe[..., None])[..., 0]
        log_sumexp = torch.log(sumexp)
        nll = torch.where(valid, log_sumexp - picked, torch.zeros_like(picked))
        ctx.save_for_backward(logits, m + log_sumexp, targets)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, lse, targets = ctx.saved_tensors
        valid = targets >= 0
        safe = torch.where(valid, targets, torch.zeros_like(targets))
        d = logits.to(torch.float32, copy=True)
        d.sub_(lse[..., None]).exp_()                            # softmax
        d.scatter_add_(-1, safe[..., None], -valid[..., None].float())
        gm = torch.where(valid, g, torch.zeros_like(g))
        return d.mul_(gm[..., None]).to(logits.dtype), None


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits [..., V] (any float dtype), targets [...] integer (< 0 =
    ignore) → per-position negative log-likelihood [...] f32 (0 at ignored
    positions)."""
    return _SoftmaxXent.apply(logits, targets.long())


class _VocabParallelXent(torch.autograd.Function):
    """_SoftmaxXent over a vocabulary split across tp: the max and Σexp
    are reduced over tp (a max all-reduce, then one sum all-reduce that
    also brings the target's shifted logit from the rank that owns it);
    the backward is local, softmax_local − onehot_local. Residuals as
    _SoftmaxXent's: the logits shard as given, a [...] lse, the targets."""

    @staticmethod
    def forward(ctx, logits, targets, mesh):
        shifted = logits.to(torch.float32, copy=True)
        m = all_reduce_max(shifted.amax(dim=-1), mesh, TP)
        shifted.sub_(m[..., None])
        v0, v1 = vocab_range(logits.shape[-1], mesh)
        mine = (targets >= v0) & (targets < v1)     # < 0 is never mine
        local = torch.where(mine, targets - v0, torch.zeros_like(targets))
        picked = shifted.gather(-1, local[..., None])[..., 0]
        sums = torch.stack([torch.exp(shifted).sum(dim=-1),
                            torch.where(mine, picked, torch.zeros_like(picked))])
        sumexp, picked = all_reduce(sums, mesh, TP).unbind(0)
        log_sumexp = torch.log(sumexp)
        valid = targets >= 0
        nll = torch.where(valid, log_sumexp - picked, torch.zeros_like(picked))
        ctx.save_for_backward(logits, m + log_sumexp, targets)
        ctx.v0 = v0
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, lse, targets = ctx.saved_tensors
        n = logits.shape[-1]
        mine = (targets >= ctx.v0) & (targets < ctx.v0 + n)
        local = torch.where(mine, targets - ctx.v0, torch.zeros_like(targets))
        d = logits.to(torch.float32, copy=True)
        d.sub_(lse[..., None]).exp_()                            # softmax
        d.scatter_add_(-1, local[..., None], -mine[..., None].float())
        gm = torch.where(targets >= 0, g, torch.zeros_like(g))
        return d.mul_(gm[..., None]).to(logits.dtype), None, None


def vocab_parallel_xent(logits_local: torch.Tensor, targets: torch.Tensor,
                        mesh) -> torch.Tensor:
    """logits_local [..., V/tp], this tp rank's shard of the vocabulary
    (rows [r·V/tp, (r + 1)·V/tp)), targets [...] integer over the whole
    vocabulary (< 0 = ignore) → per-position negative log-likelihood [...]
    f32, the same on every rank of the tp group (0 at ignored positions).
    Each rank's gradient is its shard's; a target in another rank's shard
    puts no one-hot here. Without a mesh (None): `softmax_xent`."""
    if mesh is None:
        return softmax_xent(logits_local, targets)
    return _VocabParallelXent.apply(logits_local, targets.long(), mesh)

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
"""

from __future__ import annotations

import torch


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

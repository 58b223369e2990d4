"""Tensor parallelism over the mesh's tp axis, Megatron style.

The reference maps the logical axes "heads", "mlp" and "vocab" to the
mesh's tp axis (parallel/sharding.py's rule table) and lets XLA's
partitioner place the collectives. Here the model computes on local
tensors, so each one is written out, with parallel/mesh.py's two
differentiable operators:

- `copy_over` (Megatron's f: identity forward, all-reduce backward) puts a
  replicated activation into a column-parallel product, whose weight holds
  this rank's heads or MLP columns: the input's gradient is the sum of
  every rank's share;
- `sum_over` (Megatron's g: all-reduce forward, the one copy's gradient
  backward) sums a row-parallel product's partial outputs; its bias, which
  every rank holds whole, is added once, after the sum, by the caller;
- the embedding, the LM head and the cross-entropy are split over the
  vocabulary: rank r holds rows [r·V/tp, (r + 1)·V/tp) of the table.
  `vocab_parallel_embed` looks up the ids this rank owns and sums over tp;
  `vocab_parallel_logits` gives this rank's [B, S, V/tp] logits, which
  ops/cross_entropy.py's `vocab_parallel_xent` takes as they are.

Without a mesh (mesh None, the one-device path) no helper runs a
collective. Under a mesh they run their collectives whatever tp is: at
tp 1 on a group of one, so that a one-card mesh runs the same code as
many.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.parallel.mesh import all_gather, copy_over, sum_over

TP: Tuple[str, ...] = ("tp",)


def column_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated activation on its way into column-parallel products
    (one call may feed several: q, k and v, or SwiGLU's gate and up)."""
    return x if mesh is None else copy_over(x, mesh, TP)


def row_out(partial: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's output: the partial sums of every rank's
    heads or MLP columns, summed. The caller adds the bias after it."""
    return partial if mesh is None else sum_over(partial, mesh, TP)


def vocab_range(num_local: int, mesh) -> Tuple[int, int]:
    """[v0, v0 + V/tp): the vocabulary rows this rank's shard holds."""
    v0 = 0 if mesh is None else mesh.get_local_rank("tp") * num_local
    return v0, v0 + num_local


def vocab_parallel_embed(wte_local: torch.Tensor, tokens: torch.Tensor,
                         mesh, dtype=None) -> torch.Tensor:
    """Rows of the table for `tokens` [B, S] → [B, S, D], cast to `dtype`
    after the lookup (as `wte[tokens].to(dtype)`), from this rank's
    vocabulary shard wte_local [V/tp, D]: each rank looks up the ids it
    owns, 0 for the others, and the sum over tp (one nonzero term a
    position, so exact) gives every rank every row.

    An id outside the shard reads row (id − v0) mod V/tp at weight 0: its
    gradient adds an exact 0 there, spread over the table rather than
    piled onto one row, whose backward would add them up serially."""
    dtype = dtype or wte_local.dtype
    if mesh is None:
        return wte_local[tokens].to(dtype)
    n = wte_local.shape[0]
    v0, v1 = vocab_range(n, mesh)
    mine = (tokens >= v0) & (tokens < v1)
    rows = wte_local[(tokens - v0).remainder(n)].to(dtype)
    return sum_over(rows.masked_fill(~mine[..., None], 0), mesh, TP)


def vocab_parallel_logits(x: torch.Tensor, w_local: torch.Tensor,
                          mesh) -> torch.Tensor:
    """x [B, S, D] (replicated) · w_local [D, V/tp] → this rank's logits
    [B, S, V/tp]; x's gradient is summed over tp."""
    return column_in(x, mesh) @ w_local


def gather_vocab(logits_local: torch.Tensor, mesh) -> torch.Tensor:
    """[..., V/tp] shards of every tp rank → the full [..., V] logits (not
    differentiable): for a meshed forward's caller."""
    if mesh is None:
        return logits_local
    parts = all_gather(logits_local, mesh, TP)
    return torch.cat(tuple(parts), dim=-1)

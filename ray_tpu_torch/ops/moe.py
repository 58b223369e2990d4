"""Mixture-of-experts MLP with capacity-based dispatch (counterpart of
ray_tpu/ops/moe.py).

The reference's layer, GShard style: an f32 router softmax, top-k choices
whose gates are renormalised to sum to 1, a capacity of C slots per expert
filled in k-major priority (every token's first choice outranks any second
choice), choices past C dropped (the residual carries the token), the
experts as a batched product pair over [E, C, D], and the Switch
load-balancing loss.

The reference builds dense one-hot dispatch and combine tensors [T, E, C]
and runs the layer as einsums through them: static shapes that a TPU tiles.
On the card those tensors are the cost: at GPT-2-124M's training batch with
8 experts (T 24,576, C 7,680) each holds 1.51 G entries a layer, and the two
einsums through them are about 2.3 TFLOP each of products with zeros.
`moe_mlp` computes the same function by index, with static shapes and no
host synchronisation:

- dispatch: each kept (token, choice) is written into its own slot of a
  zeroed [E·C, D] buffer (its backward is a gather); a dropped choice
  writes to one extra row that is cut off;
- combine: each token gathers its k slots and sums them weighted by the
  gate rounded to the compute dtype, in f32 (its backward writes to unique
  slots).

No token's rows are summed by atomics, so the layer is bitwise repeatable
on the card. Empty slots still run through the experts (gelu(fc_b)·out_w +
out_b is not 0) and get combine weight 0, as in the reference.

`moe_mlp_plain` is the reference's formulation, einsum for einsum; the tests
and chip_smoke.py hold `moe_mlp` against it, and nothing in the models or
the training step calls it. No kernel is written by hand here: the
reference has no Pallas kernel in this layer, and its expert products are
plain batched matrix products (torch.bmm here, as XLA's dots there).

Under a device mesh (parallel/mesh.py's `current_mesh`, which the train
step enters) the layer still computes the reference's function of the
GLOBAL batch, whose rows are split over (dp, fsdp) and whose sequences are
split over cp (TOKEN_AXES):
- the capacity counts every rank's tokens, and each choice's place in its
  expert's queue counts the choices before it in the global k-major order
  over the flattened (batch, sequence) token axis, where a rank's tokens
  are not contiguous under cp (its chunk of each of its rows): an
  all-gather of [k, rows, E] counts over TOKEN_AXES (`_global_queue`);
- the load-balancing loss is E · Σ_e (global top-1 share) · (global mean
  probability): a product of means over TOKEN_AXES;
- with ep > 1 a rank holds E/ep experts (`moe_logical_axes` puts the
  expert dim on ep). The ranks of an ep group hold the same tokens, so
  each runs its experts on its dispatch slots and the combined outputs are
  summed over the group: no all-to-all, as in the reference's layout;
- a rank's buffer holds min(C, T) slots an expert (T its own tokens):
  only its tokens fill them;
- with tp > 1 a rank holds F/tp of each expert's MLP columns (fc_w and
  fc_b on "mlp", out_w on "mlp"; router_w and out_b whole). The ranks of
  a tp group hold the same tokens and the same router, so they route
  alike; the experts' input goes in by copy_over over (ep, tp), and the
  out product's partial sums are summed over tp BEFORE the combine, with
  out_b added after the sum: the combine and the gate's gradient then
  see whole expert outputs, the same on every tp rank, and out_b counts
  once. (Summing after the combine moves a [T, D] f32 tensor instead of
  the [E·C, D] compute-dtype slots, about 0.8× the bytes at capacity
  factor 1.25 and top-2, but needs out_b's share summed over ep and not
  tp, and the gate's gradient summed over tp: two more collectives.)
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.mesh import (
    BATCH_AXES, TOKEN_AXES, all_gather, all_reduce, axis_index, axis_size,
    copy_over, current_mesh, sum_over,
)
from ray_tpu_torch.parallel.tensor import row_out


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    return max(
        1, int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    )


def moe_param_shapes(num_layers: int, d_model: int, d_ff: int,
                     num_experts: int) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the layer-stacked expert parameters."""
    L, D, F_, E = num_layers, d_model, d_ff, num_experts
    return {
        "router_w": (L, D, E),
        "fc_w": (L, E, D, F_),
        "fc_b": (L, E, F_),
        "out_w": (L, E, F_, D),
        "out_b": (L, E, D),
    }


def moe_init(generator: torch.Generator, num_layers: int, d_model: int,
             d_ff: int, num_experts: int, param_dtype=torch.float32,
             resid_std: float = 0.02, device="cuda") -> Dict[str, torch.Tensor]:
    """Per-layer stacked expert parameters ([L, E, ...], matching blocks):
    router_w and fc_w N(0, 0.02), out_w N(0, resid_std), biases 0 (the JAX
    init's distribution, not its numbers). Random numbers are drawn on the
    generator's device, then moved."""
    stds = {"router_w": 0.02, "fc_w": 0.02, "out_w": resid_std}

    def make(name, shape):
        if name in stds:
            x = torch.randn(
                shape, generator=generator, device=generator.device,
                dtype=torch.float32,
            ).mul_(stds[name])
            return x.to(device=device, dtype=param_dtype)
        return torch.zeros(shape, dtype=param_dtype, device=device)

    shapes = moe_param_shapes(num_layers, d_model, d_ff, num_experts)
    return {k: make(k, s) for k, s in shapes.items()}


def moe_logical_axes() -> Dict[str, Any]:
    """Logical axes of one layer-stacked MoE parameter tree: the `expert`
    axis maps to the mesh's ep dimension (parallel/sharding.py)."""
    return {
        "router_w": ("layers", "embed", None),
        "fc_w": ("layers", "expert", "embed", "mlp"),
        "fc_b": ("layers", "expert", "mlp"),
        "out_w": ("layers", "expert", "mlp", "embed"),
        "out_b": ("layers", "expert", "embed"),
    }


class Routing(NamedTuple):
    """One layer's routing of T tokens to k of E experts."""

    probs: torch.Tensor   # [T, E] f32 router softmax
    gate: torch.Tensor    # [T, k] f32, renormalised over the k choices
    expert: torch.Tensor  # [T, k] int64, in lax.top_k's order
    pos: torch.Tensor     # [T, k] int64, place in the expert's queue
    keep: torch.Tensor    # [T, k] bool, pos < capacity


def router_probs(xt: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """f32 router softmax [T, E] of tokens xt [T, D]. Both formulations
    compute it here, so that their routing can be compared decision for
    decision."""
    return torch.softmax(xt.float() @ router_w.float(), dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """lax.top_k: the k largest, the lower index first among equal values.
    torch.topk promises no order for ties; a stable descending sort keeps
    the index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _renormalise(vals: torch.Tensor) -> torch.Tensor:
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)


def route(xt: torch.Tensor, router_w: torch.Tensor, top_k: int,
          capacity: int) -> Routing:
    """The routing `moe_mlp` runs: top-k with ties to the lower index, gates
    renormalised before any drop, and each choice's place in its expert's
    queue counted in integers in k-major order (what the reference's f32
    cumsum counts)."""
    probs = router_probs(xt, router_w)
    vals, expert = _top_k(probs, top_k)
    E = probs.shape[-1]
    flat = expert.t().reshape(-1)                              # [k*T] k-major
    # [E, k*T]: a scan along the contiguous dimension (PyTorch scans an
    # outer dimension with one thread a column, serially: milliseconds)
    onehot = (torch.arange(E, device=xt.device)[:, None] == flat).int()
    pos = onehot.cumsum(1).gather(0, flat[None])[0] - 1        # earlier, same e
    pos = pos.view(top_k, -1).t()
    return Routing(probs, _renormalise(vals), expert, pos, pos < capacity)


def _aux_loss(probs: torch.Tensor, first_choice: torch.Tensor) -> torch.Tensor:
    """Switch load-balancing loss: E · Σ_e (top-1 share of e) · (mean prob
    of e), f32."""
    E = probs.shape[-1]
    top1 = (first_choice[:, None] == torch.arange(E, device=probs.device)).float()
    return E * (top1.mean(0) * probs.mean(0)).sum()


def _choice_counts(r: Routing, rows: int) -> torch.Tensor:
    """[k, rows, E]: how many of choice j of each row's tokens go to each
    expert, for a routing of `rows` rows' tokens in row order."""
    T, k = r.expert.shape
    idx = r.expert.t().reshape(k, rows, T // rows)
    counts = torch.zeros(k, rows, r.probs.shape[-1], dtype=torch.long,
                         device=idx.device)
    return counts.scatter_add_(2, idx, torch.ones_like(idx))


def _queue(r: Routing, capacity: int, every: torch.Tensor, b: int,
           c: int) -> Routing:
    """`r`, the routing of the tokens of batch rank b's rows in sequence
    chunk c, with places counted among them (`route`), with each place
    moved to the token's place in the global k-major order over the
    flattened (batch, sequence) token axis: behind every rank's choices
    j' < j of the same expert, then behind its choices j in the rows of
    the batch ranks before b (all their chunks), in b's earlier rows (all
    their chunks: other ranks hold the other chunks of a row), and in the
    earlier chunks of its own row. every: [batch ranks, cp, k, rows, E],
    each rank's `_choice_counts`."""
    T, k = r.expert.shape
    _, _, _, rows, E = every.shape
    counts = every[b, c]

    def before(x, dim):     # Σ of the entries before each along dim
        return x.cumsum(dim) - x

    row = every[b].sum(0)                                       # [k, rows, E]
    place = (before(every.sum((0, 1, 3)), 0) + every[:b].sum((0, 1, 3)))[:, None] \
        + before(row, 1) + every[b, :c].sum(0)                 # [k, rows, E]
    # route() counted this rank's choices j' < j, then its earlier rows'
    offset = place - before(counts.sum(1), 0)[:, None] - before(counts, 1)
    at = ((torch.arange(T, device=r.expert.device) // (T // rows))[:, None] * E
          + r.expert)
    pos = r.pos + offset.view(k, rows * E).gather(1, at.t()).t()
    return Routing(r.probs, r.gate, r.expert, pos, pos < capacity)


def _global_queue(r: Routing, capacity: int, rows: int, mesh) -> Routing:
    """`_queue` over the mesh: this rank's routing of its `rows` rows (its
    chunk of each), the counts of every rank all-gathered over
    TOKEN_AXES."""
    counts = _choice_counts(r, rows)
    every = all_gather(counts, mesh, TOKEN_AXES).view(
        axis_size(mesh, BATCH_AXES), axis_size(mesh, ("cp",)), *counts.shape)
    return _queue(r, capacity, every, axis_index(mesh, BATCH_AXES),
                  mesh.get_local_rank("cp"))


def _global_aux_loss(probs: torch.Tensor, first_choice: torch.Tensor,
                     num_tokens: int, mesh) -> torch.Tensor:
    """`_aux_loss` over the global batch: each factor is a mean over every
    rank's tokens (TOKEN_AXES), the probabilities' differentiably
    (sum_over)."""
    E = probs.shape[-1]
    top1 = (first_choice[:, None] == torch.arange(E, device=probs.device)).float()
    frac_tokens = all_reduce(top1.sum(0), mesh, TOKEN_AXES) / num_tokens
    frac_probs = sum_over(probs.sum(0), mesh, TOKEN_AXES) / num_tokens
    return E * (frac_tokens * frac_probs).sum()


def moe_mlp(x: torch.Tensor, params: Dict[str, Any], *, top_k: int,
            capacity_factor: float = 1.25, dtype=torch.bfloat16):
    """x: [B, S, D] → ([B, S, D] in dtype, aux_loss f32 scalar).

    params hold ONE layer's tensors (no leading L): router_w [D, E],
    fc_w [E, D, F], fc_b [E, F], out_w [E, F, D], out_b [E, D] (under a
    mesh: E/ep experts and F/tp columns, this rank's). The reference's
    function, dispatched by index (module docstring)."""
    B, S, D = x.shape
    T = B * S
    E = params["router_w"].shape[-1]
    mesh = current_mesh()
    tokens = T if mesh is None else T * axis_size(mesh, TOKEN_AXES)
    C = moe_capacity(tokens, E, top_k, capacity_factor)
    xt = x.reshape(T, D)
    r = route(xt, params["router_w"], top_k, C)
    local_pos = r.pos                  # place among this rank's tokens
    E_here, slots, first, gate = E, C, 0, r.gate
    if mesh is not None:
        r = _global_queue(r, C, B, mesh)
        E_here, slots = params["fc_w"].shape[0], min(C, T)
        first = mesh.get_local_rank("ep") * E_here
        # each ep rank uses these for its own experts' share of y, each tp
        # rank the experts' input for its own MLP columns
        xt = copy_over(xt, mesh, ("ep", "tp"))
        gate = copy_over(r.gate, mesh, ("ep",))
    here = r.keep & (r.expert >= first) & (r.expert < first + E_here)
    rows_here = E_here * slots

    # [T, k] slot of each choice in the flat [E·C] buffer
    slot = (r.expert - first) * slots + local_pos
    # dispatch: a kept choice to its own slot, a dropped one to row E·C
    dest = torch.where(here, slot, rows_here).reshape(-1)
    src = xt.to(dtype).unsqueeze(1).expand(T, top_k, D).reshape(T * top_k, D)
    buf = torch.zeros(rows_here + 1, D, dtype=dtype, device=x.device)
    xin = buf.index_copy(0, dest, src)[:rows_here].view(E_here, slots, D)

    h = torch.bmm(xin, params["fc_w"].to(dtype)) + params["fc_b"].to(dtype)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    out = (row_out(torch.bmm(h, params["out_w"].to(dtype)), mesh)
           + params["out_b"].to(dtype)[:, None, :])

    # combine: each token's k slots, weighted by the gate rounded to dtype,
    # summed in f32. A dropped choice reads some row at weight 0, each its
    # own (i mod E·C): its gradient adds an exact 0 there, and no row
    # collects many of them (the backward sums each row's entries serially)
    spread = torch.arange(T * top_k, device=x.device).view(T, top_k) % rows_here
    rows = out.view(rows_here, D)[torch.where(here, slot, spread).reshape(-1)]
    weight = (gate * here).to(dtype).float()
    # bf16 products are exact in f32: one rounding, as the reference's
    # einsum (a batched product over k instead falls to slow cuBLAS kernels
    # for so many 1 x k x D problems)
    y = (rows.view(T, top_k, D).float() * weight[..., None]).sum(1)
    if mesh is None:
        return y.to(dtype).view(B, S, D), _aux_loss(r.probs, r.expert[:, 0])
    y = sum_over(y, mesh, ("ep",)).to(dtype)
    return y.view(B, S, D), _global_aux_loss(r.probs, r.expert[:, 0], tokens, mesh)


def route_plain(xt: torch.Tensor, router_w: torch.Tensor, top_k: int,
                capacity: int):
    """The reference's routing, tensor for tensor: f32 one-hot choices
    [T, k, E], positions by an f32 cumsum in k-major order, and the dense
    dispatch and combine [T, E, C]. Returns (Routing, onehot, dispatch,
    combine)."""
    probs = router_probs(xt, router_w)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = _renormalise(gate_vals)
    T, E = probs.shape
    onehot = (gate_idx[..., None] == torch.arange(E, device=xt.device)).float()
    flat = onehot.transpose(0, 1).reshape(top_k * T, E)        # k-major
    position = torch.cumsum(flat.t(), dim=1).t() - flat        # along k*T
    pos_in_expert = (position * flat).sum(-1)
    keep = (pos_in_expert < capacity).float()
    pos = pos_in_expert.view(top_k, T).t()
    keep = keep.view(top_k, T).t()
    slot_onehot = (pos.long()[..., None]
                   == torch.arange(capacity, device=xt.device)).float()
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None], slot_onehot)
    combine = torch.einsum(
        "tke,tkc->tec", onehot * (gate_vals * keep)[..., None], slot_onehot
    )
    routing = Routing(probs, gate_vals, gate_idx, pos.long(), keep.bool())
    return routing, onehot, dispatch, combine


def moe_mlp_plain(x: torch.Tensor, params: Dict[str, Any], *, top_k: int,
                  capacity_factor: float = 1.25, dtype=torch.bfloat16):
    """`moe_mlp` in the reference's formulation (ray_tpu/ops/moe.py:
    moe_mlp), through the dense dispatch and combine tensors. For the
    tests and chip_smoke.py only."""
    B, S, D = x.shape
    T = B * S
    E = params["router_w"].shape[-1]
    C = moe_capacity(T, E, top_k, capacity_factor)
    xt = x.reshape(T, D)
    r, onehot, dispatch, combine = route_plain(xt, params["router_w"], top_k, C)

    xin = torch.einsum("tec,td->ecd", dispatch.to(dtype), xt.to(dtype))
    h = torch.einsum("ecd,edf->ecf", xin, params["fc_w"].to(dtype))
    h = h + params["fc_b"].to(dtype)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, params["out_w"].to(dtype))
    out = out + params["out_b"].to(dtype)[:, None, :]
    y = torch.einsum("tec,ecd->td", combine.to(dtype), out)

    frac_tokens = onehot[:, 0, :].mean(0)                      # top-1 share
    frac_probs = r.probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum()
    return y.view(B, S, D), aux.float()

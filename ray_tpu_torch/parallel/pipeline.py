"""Pipeline parallelism: the GPipe schedule (counterpart of
ray_tpu/parallel/pipeline.py's `pipeline_apply` and `stages_from_layers`).

The reference runs the schedule as one SPMD program: a scan over
M + P - 1 ticks, each tick a vmap of the stage function over the stage
dimension (sharded over the mesh's pp axis) followed by a roll of the
stage dimension, which XLA lowers to a CollectivePermute. Here each rank
of a pp process group holds one stage and runs the same ticks; the roll
becomes a ring shift (send to rank r + 1, receive from rank r - 1,
the reverse in its backward), so that torch.autograd differentiates the
whole schedule as jax.grad does the scan. Without a group, all stages run
in this process, tick by tick.

A (stage, tick) pair is live when stage s works on microbatch t - s in
[0, M); the others are the pipeline's bubble. They are skipped: a dead
stage passes its input on unchanged, which keeps every rank's ticks, and
so its sends and receives, in step.

The reference's ActorPipeline (a schedule over compiled-graph actors) is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def stages_from_layers(layers: Any, num_stages: int) -> Any:
    """Reshape stacked per-layer params [L, ...] → [P, L/P, ...] (contiguous
    stage chunks, so a `layers`→`pp` sharding carries over to the stage dim)."""
    if isinstance(layers, dict):
        return {k: stages_from_layers(v, num_stages) for k, v in layers.items()}
    L = layers.shape[0]
    if L % num_stages:
        raise ValueError(f"layer count {L} not divisible by pp={num_stages}")
    return layers.reshape((num_stages, L // num_stages) + tuple(layers.shape[1:]))


def _stage(stage_params: Any, s: int) -> Any:
    if isinstance(stage_params, dict):
        return {k: _stage(v, s) for k, v in stage_params.items()}
    return stage_params[s]


def _exchange(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to the rank `shift` places on in the ring, return what the
    rank `shift` places back sent."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to),
                                       dist.P2POp(dist.irecv, out, frm)]):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, -1), None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    *,
    num_stages: int,
    num_microbatches: int,
    group=None,
) -> torch.Tensor:
    """Run `x` through `num_stages` pipeline stages with a GPipe schedule.

    stage_fn:      (stage_layers, h) -> h, applied per stage; stage_layers is
                   stage_params with the leading stage dim indexed away, h is
                   one microbatch of activations.
    stage_params:  (nested dict of) tensors with a leading stage dim:
                   `num_stages` of them without a group, this rank's one
                   stage (leading dim 1) with a group.
    x:             [B, ...] activations, B divisible by num_microbatches
                   (with a group, only the first stage reads them).
    group:         None, or the pp process group: rank r runs stage r.

    Returns [B, ...]: stage_{P-1}(...stage_0(x)...) per microbatch,
    reassembled in order. With a group that holds on the group's last rank;
    on the others it holds that rank's own outputs of the same ticks, and
    a backward through it (with any gradient) runs that rank's share of
    the schedule's backward.
    """
    P_, M = num_stages, num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by num_microbatches {M}")
    if group is not None and dist.get_world_size(group) != P_:
        raise ValueError(f"num_stages {P_} is not the group's size "
                         f"{dist.get_world_size(group)}")
    xm = x.reshape((M, B // M) + tuple(x.shape[1:]))
    ticks = M + P_ - 1

    if group is None:
        # state[s]: stage s's input this tick
        state = [None] * P_
        outputs = []
        for t in range(ticks):
            state[0] = xm[t] if t < M else None
            out = [stage_fn(_stage(stage_params, s), state[s])
                   if 0 <= t - s < M else None for s in range(P_)]
            if t >= P_ - 1:
                outputs.append(out[P_ - 1])
            state = [None] + out[:-1]
        return torch.cat(outputs)

    r = dist.get_rank(group)
    layers = _stage(stage_params, 0)
    # requires grad: a rank's first shifts carry only this (dead) state, and
    # a shift of a value without grad would have no backward on that rank
    # while its peer's has one
    state = torch.zeros_like(xm[0], requires_grad=torch.is_grad_enabled())
    outputs = []
    for t in range(ticks):
        if r == 0:
            # stage 0 ingests microbatch t while the pipeline fills; where
            # keeps the received (dead) value in the graph, so that every
            # ring shift's backward is reached in tick order
            feed = xm[min(t, M - 1)]
            state = torch.where(torch.tensor(t < M, device=x.device), feed, state)
        out = stage_fn(layers, state) if 0 <= t - r < M else state
        if t >= P_ - 1:
            outputs.append(out)
        if t < ticks - 1:     # the last tick's shift would feed no tick
            state = _RingShift.apply(out, group)
    return torch.cat(outputs)

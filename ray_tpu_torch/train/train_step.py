"""Training step of the PyTorch port, on one device or over a device mesh.

Counterpart of ray_tpu/train/train_step.py: `default_optimizer`,
`make_gpt2_train_step`, `make_llama_train_step` and `synthetic_batch`. The
JAX step is one jitted function over a mesh with donated buffers; here the
step runs eagerly and updates the parameters and the optimizer's moments in
place.

With `mesh` (parallel/mesh.py: dp, fsdp, ep, tp, pp and cp) the step is
still the reference's function of the GLOBAL batch, and every rank takes
its block of it: its rows, and over cp its chunk of the sequence. Each
parameter lives as a DTensor whose placements come from the model's
`logical_axes` and the rule table (parallel/sharding.py); its local shard
is what the optimizer updates, and the moments follow it. A step gathers
each shard over the batch axes that shard it (sharding.working_tree),
runs the forward and backward on this rank's block with the loss divided
by the global count of targets, then
sums each gradient over the ranks whose contributions are disjoint: the
batch axes (reduce-scattered back to the shard where they shard it), cp
(each rank's chunk of the sequence; ring attention hands each rank the
gradient of its own k and v, the gathered attention the sum of every
rank's share of it) and, in a pipelined plan, pp for a parameter every
stage holds (the first stage's embedding plus the last stage's head); the
count of targets and the loss are summed over the batch axes and cp too,
and the loss over a pipeline's pp. Never over ep or tp, nor over pp where
the plan is not pipelined (Llama's, as the reference's): the ranks of
such a group hold the same block and compute the same loss; the MoE
layer's and the tensor-parallel products' collectives (parallel/tensor.py)
hand each rank the whole gradient of what it holds, its shard of a leaf
split over tp or ep, or the whole of a leaf it holds whole. The clipping
norm counts every element once. A mesh of one device runs the same code,
with its collectives on groups of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple,
)

import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER, BATCH_AXES, all_reduce, broadcast, local_batch, mesh_spec,
    reduce_scatter_dims, use_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    batch_gather_dims, shard_tree, working_tree,
)

_f32 = np.float32


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule, in float32 as optax computes it:
    linear from init_value to peak_value over warmup_steps, then cosine
    decay to end_value at decay_steps (which counts the warmup too)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = _f32(1) - _f32(count) / _f32(warmup_steps)
            value = _f32(init_value - peak_value) * frac + _f32(peak_value)
        else:
            c = _f32(min(count - warmup_steps, cosine_steps))
            cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(cosine_steps)))
            value = _f32(peak_value) * (_f32(1 - alpha) * cosine + _f32(alpha))
        return float(value)

    return schedule


class ClippedAdamW(torch.optim.Optimizer):
    """The reference's optax chain as one optimizer, over one param group:

        clip_by_global_norm(grad_clip)        g·grad_clip/‖g‖ when ‖g‖ ≥ grad_clip
        Adam, moments stored in moment_dtype  updated in f32, bias-corrected
        add_decayed_weights(weight_decay)     on EVERY parameter
        scale_by_learning_rate(schedule)      −schedule(count), count from 0

    so the first update has lr = schedule(0) (0 under warmup from 0) while
    Adam's bias correction already counts it as step 1. After each step,
    `grad_norm` holds the global norm of the gradients before clipping (a
    0-d f32 tensor on the parameters' device). A meshed step, whose
    parameters are shards, hands `step` the global norm."""

    def __init__(
        self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
        weight_decay: float = 0.1, b1: float = 0.9, b2: float = 0.95,
        grad_clip: float = 1.0, eps: float = 1e-8,
        moment_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__(params, dict(
            weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip,
            eps=eps, moment_dtype=moment_dtype,
        ))
        if len(self.param_groups) != 1:
            raise ValueError("one param group: the decay applies to all")
        self.schedule = schedule
        self.count = 0          # updates applied so far
        self.grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update; the clip uses `grad_norm` when given, else the norm
        of this optimizer's gradients."""
        group = self.param_groups[0]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        params = [p for p in group["params"] if p.grad is not None]
        norm = grad_norm if grad_norm is not None else torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad, dtype=torch.float32)
                         for p in params]))
        keep = norm < group["grad_clip"]
        count = self.count + 1
        bc1 = float(_f32(1) - _f32(b1) ** _f32(count))
        bc2 = float(_f32(1) - _f32(b2) ** _f32(count))
        lr = self.schedule(self.count)
        for p in params:
            state = self.state[p]
            if not state:
                state["mu"] = torch.zeros_like(p, dtype=group["moment_dtype"])
                state["nu"] = torch.zeros_like(p, dtype=group["moment_dtype"])
            g = p.grad.float()
            g = torch.where(keep, g, g / norm * group["grad_clip"])
            m = state["mu"].float().mul_(b1).add_(g * (1 - b1))
            v = state["nu"].float().mul_(b2).add_(g * g * (1 - b2))
            update = (m / bc1) / ((v / bc2).sqrt_().add_(eps))
            update.add_(p.float(), alpha=group["weight_decay"]).mul_(-lr)
            p.add_(update.to(p.dtype))
            state["mu"].copy_(m)
            state["nu"].copy_(v)
        self.count = count
        self.grad_norm = norm


def default_optimizer(
    lr: float = 3e-4, weight_decay: float = 0.1, warmup: int = 100,
    total_steps: int = 10_000, b1: float = 0.9, b2: float = 0.95,
    grad_clip: float = 1.0, eps: float = 1e-8,
    moment_dtype: torch.dtype = torch.bfloat16,
) -> Callable[[Iterable[torch.Tensor]], ClippedAdamW]:
    """AdamW with warmup-cosine LR (to 0.1·lr), global-norm clipping and
    bf16-stored moments, as the reference's default_optimizer. Returns a
    factory: call it with the parameters to get the optimizer."""
    schedule = warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total_steps, warmup + 1), end_value=lr * 0.1
    )
    return partial(
        ClippedAdamW, schedule=schedule, weight_decay=weight_decay, b1=b1,
        b2=b2, grad_clip=grad_clip, eps=eps, moment_dtype=moment_dtype,
    )


@dataclass
class TrainStepBundle:
    """Everything a training loop needs: initialized state + step fn."""

    state: Dict[str, Any]          # {"params", "opt_state", "step"}
    step_fn: Callable              # (state, batch) -> (state, metrics)
    cfg: Any
    # (state, batches) -> (state, stacked metrics) over a leading step axis
    # of batches {"tokens": [N, B, S], "targets": [N, B, S]}: step_fn in a
    # loop, with the same results
    multi_step_fn: Callable
    mesh: Any = None               # the DeviceMesh, None on one device
    # a global batch → this rank's rows (what step_fn takes of it); None on
    # one device
    local_batch: Optional[Callable] = None
    # the rule updates the parameters were placed with (a pipelined plan's
    # layers → pp among them): shard_tree(mesh, tree, logical_axes, rules)
    # places a full tree as the state holds it
    rules: Optional[Dict] = None


def named_leaves(params: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of a (nested) parameter dict, in insertion
    order, e.g. ("blocks.qkv_w", ...)."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from named_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a (nested) parameter dict, in named_leaves' order."""
    return [v for _, v in named_leaves(params)]


def _unflatten(names: List[str], values: List[Any]) -> Dict[str, Any]:
    """The nested dict whose named_leaves are zip(names, values)."""
    tree: Dict[str, Any] = {}
    for name, v in zip(names, values):
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _multi_step(step_fn):
    def multi_step_fn(state, batches):
        metrics = []
        for i in range(len(batches["tokens"])):
            state, m = step_fn(state, {k: v[i] for k, v in batches.items()})
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return multi_step_fn


def _make_train_step(model, cfg, optimizer, generator, device, mesh=None,
                     rules=None) -> TrainStepBundle:
    """Initialize `model` (a module with `init`, `loss_fn`, `loss_terms`
    and `logical_axes`, e.g. models.gpt2) on `device` and build its train
    step: forward, backward (the flash kernels on a CUDA device), then the
    optimizer; over `mesh` when one is given (module docstring).

    `optimizer` is a factory such as `default_optimizer()` returns (the
    default). `step_fn(state, batch)` updates state["params"] and the
    optimizer in place and returns (state, {"loss", "grad_norm"}), 0-d
    tensors on the device (reading them synchronizes), the same on every
    rank of a mesh."""
    if mesh is not None:
        return _make_mesh_train_step(model, cfg, optimizer, generator,
                                     device, mesh, rules)
    device = torch.device(device)
    if optimizer is None:
        optimizer = default_optimizer()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = model.init(cfg, generator, device=device)
    for p in param_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt_state": optimizer(param_leaves(params)),
             "step": 0}

    def step_fn(state, batch):
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss = model.loss_fn(
            state["params"], torch.as_tensor(batch["tokens"], device=device),
            torch.as_tensor(batch["targets"], device=device), cfg,
        )
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": opt.grad_norm}

    return TrainStepBundle(state=state, step_fn=step_fn, cfg=cfg,
                           multi_step_fn=_multi_step(step_fn))


def _mesh_rules(model, cfg, mesh, rules):
    """The reference's checks of a mesh plan (ray_tpu/train/train_step.py)
    and the widths tp and cp must divide; returns the rules, with the
    layer stack on pp for a pipelined plan (GPT-2 over pp > 1; Llama runs
    no pipeline, as the reference's does not, and pp is a replica axis
    there)."""
    spec = mesh_spec(mesh)
    if cfg.seq_len % spec.cp:
        raise ValueError(
            f"sequence length {cfg.seq_len} not divisible by cp axis "
            f"size {spec.cp}; pad the sequence or change the mesh")
    widths = {"n_head": cfg.n_head, "d_ff": cfg.d_ff,
              "padded_vocab": cfg.padded_vocab}
    if model is llama:
        widths["n_kv_head"] = cfg.n_kv_head
    for name, n in widths.items():
        if n % spec.tp:
            raise ValueError(f"{name}={n} not divisible by tp={spec.tp}: "
                             "tensor parallelism splits it over the tp axis")
    if spec.pp > 1 and model is gpt2:
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "pipeline parallelism with MoE blocks is not supported yet; "
                "use a pp=1 mesh for MoE configs"
            )
        if cfg.n_layer % spec.pp:
            raise ValueError(
                f"n_layer={cfg.n_layer} not divisible by pp={spec.pp}")
        rules = {"layers": "pp", **(rules or {})}
    return rules


class _LeafPlan(NamedTuple):
    """How a meshed step moves one parameter and its gradient."""

    # (batch axis, dim) pairs that shard it, in mesh order: its shard is
    # gathered over them for the step, its gradient reduce-scattered back
    gather: List[Tuple[str, int]]
    summed: Tuple[str, ...]     # the other axes its gradient is summed over
    # ep, tp and (unpipelined) pp, where it is replicated: every rank of
    # the group computes the same gradient, but kernels that accumulate in
    # a run-dependent order (the embedding's backward) may round it
    # differently, so the first rank's is handed to the others and the
    # replicas never drift apart
    copied: Tuple[str, ...]
    sharded: Tuple[str, ...]    # every axis that shards it (for the norm)


def _disjoint_axes(pipelined: bool) -> Tuple[str, ...]:
    """The axes whose ranks hold disjoint shares of the step's work, over
    which the loss and the gradients are summed: the batch axes, cp, and pp
    only in a pipelined plan, where its ranks hold disjoint stages (a leaf
    every stage holds gets the first stage's embedding gradient plus the
    last stage's head's, the loss is the last stage's plus the others' 0);
    elsewhere pp is a replica axis, as ep and tp are."""
    return BATCH_AXES + (("pp",) if pipelined else ()) + ("cp",)


def _leaf_plan(placements, pipelined: bool) -> _LeafPlan:
    from torch.distributed.tensor import Shard

    shard = {a: p.dim for a, p in zip(AXIS_ORDER, placements)
             if isinstance(p, Shard)}
    replica = ("ep", "tp") + (() if pipelined else ("pp",))
    return _LeafPlan(
        gather=batch_gather_dims(placements),
        summed=tuple(a for a in _disjoint_axes(pipelined) if a not in shard),
        copied=tuple(a for a in AXIS_ORDER if a in replica and a not in shard),
        sharded=tuple(shard))


def _grad_norm(grads, plans, mesh) -> torch.Tensor:
    """The global norm: each leaf's squares summed over the ranks that hold
    its disjoint shards, once per element (replicas are not counted)."""
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, plan in zip(grads, plans):
        sq = g.float().square().sum()
        key = plan.sharded
        sums[key] = sums[key] + sq if key in sums else sq
    return sum(all_reduce(sq, mesh, axes) for axes, sq in sums.items()).sqrt()


def _make_mesh_train_step(model, cfg, optimizer, generator, device, mesh,
                          rules) -> TrainStepBundle:
    rules = _mesh_rules(model, cfg, mesh, rules)
    pipelined = (rules or {}).get("layers") == "pp"
    device = torch.device(device)
    if optimizer is None:
        optimizer = default_optimizer()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    # every rank draws the full tree from the same seed; rank 0's is placed
    params = shard_tree(mesh, model.init(cfg, generator, device=device),
                        model.logical_axes(cfg), rules)
    names = [n for n, _ in named_leaves(params)]
    with torch.no_grad():       # the DTensors' own local tensors
        shards = [d.to_local() for d in param_leaves(params)]
    for p in shards:
        p.requires_grad_(True)
    plans = [_leaf_plan(d.placements, pipelined) for d in param_leaves(params)]
    state = {"params": params, "opt_state": optimizer(shards), "step": 0}

    def step_fn(state, batch):
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        rows = local_batch(mesh, batch)
        tokens = torch.as_tensor(rows["tokens"], device=device)
        targets = torch.as_tensor(rows["targets"], device=device)
        count = all_reduce((targets >= 0).sum(), mesh,
                           BATCH_AXES + ("cp",)).clamp(min=1)
        work = param_leaves(working_tree(state["params"]))
        for w in work:
            w.requires_grad_(True)
        with use_mesh(mesh):
            total, aux_term = model.loss_terms(
                _unflatten(names, work), tokens, targets, cfg)
            (total / count + aux_term).backward()
        for p, w, plan in zip(shards, work, plans):
            g = w.grad if w.grad is not None else torch.zeros_like(w)
            g = all_reduce(reduce_scatter_dims(g, mesh, plan.gather), mesh,
                           plan.summed)
            p.grad = broadcast(g, mesh, plan.copied)
        norm = _grad_norm([p.grad for p in shards], plans, mesh)
        opt.step(grad_norm=norm)
        state["step"] += 1
        total = all_reduce(total.detach().clone(), mesh,
                           _disjoint_axes(pipelined))
        aux = aux_term.detach() if torch.is_tensor(aux_term) else aux_term
        return state, {"loss": total / count + aux, "grad_norm": norm}

    return TrainStepBundle(
        state=state, step_fn=step_fn, cfg=cfg,
        multi_step_fn=_multi_step(step_fn), mesh=mesh,
        local_batch=lambda batch: local_batch(mesh, batch), rules=rules)


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def make_gpt2_train_step(
    cfg: gpt2.GPT2Config,
    optimizer: Optional[OptimizerFactory] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    *,
    mesh=None,
    rules: Optional[Dict] = None,
) -> TrainStepBundle:
    """GPT-2 (models.gpt2) on `device` and its train step, over `mesh`
    (with the rule table updated by `rules`) when one is given; see
    `_make_train_step`."""
    return _make_train_step(gpt2, cfg, optimizer, generator, device, mesh, rules)


def make_llama_train_step(
    cfg: llama.LlamaConfig,
    optimizer: Optional[OptimizerFactory] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    *,
    mesh=None,
    rules: Optional[Dict] = None,
) -> TrainStepBundle:
    """Llama (models.llama) on `device` and its train step, over `mesh`
    when one is given; see `_make_train_step`."""
    return _make_train_step(llama, cfg, optimizer, generator, device, mesh, rules)


def synthetic_batch(cfg, global_batch: int, seed: int = 0):
    """Deterministic fake LM batch (benchmarks + tests): numpy int32 tokens
    [B, seq_len] in [0, vocab_size) and next-token targets, last = -1.
    Identical to the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(
        0, cfg.vocab_size, size=(global_batch, cfg.seq_len), dtype=np.int32
    )
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    return {"tokens": tokens, "targets": targets}

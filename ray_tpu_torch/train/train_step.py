"""Training step of the PyTorch port, on one device.

Counterpart of ray_tpu/train/train_step.py: `default_optimizer`,
`make_gpt2_train_step`, `make_llama_train_step` and `synthetic_batch`. The JAX step is one jitted
function over a mesh with donated buffers; here the step runs eagerly on
one device and updates the parameters and the optimizer's moments in place.
Meshes and shardings come with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama

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
    0-d f32 tensor on the parameters' device)."""

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
    def step(self) -> None:
        group = self.param_groups[0]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        params = [p for p in group["params"] if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad, dtype=torch.float32) for p in params]
        ))
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


def _make_train_step(model, cfg, optimizer, generator, device) -> TrainStepBundle:
    """Initialize `model` (a module with `init` and `loss_fn`, e.g.
    models.gpt2) on `device` and build its train step: forward, backward
    (the flash kernels on a CUDA device), then the optimizer.

    `optimizer` is a factory such as `default_optimizer()` returns (the
    default). `step_fn(state, batch)` updates state["params"] and the
    optimizer in place and returns (state, {"loss", "grad_norm"}), 0-d
    tensors on the device (reading them synchronizes)."""
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

    def multi_step_fn(state, batches):
        metrics = []
        for i in range(len(batches["tokens"])):
            state, m = step_fn(state, {k: v[i] for k, v in batches.items()})
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return TrainStepBundle(state=state, step_fn=step_fn, cfg=cfg,
                           multi_step_fn=multi_step_fn)


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def make_gpt2_train_step(
    cfg: gpt2.GPT2Config,
    optimizer: Optional[OptimizerFactory] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> TrainStepBundle:
    """GPT-2 (models.gpt2) on `device` and its train step; see
    `_make_train_step`."""
    return _make_train_step(gpt2, cfg, optimizer, generator, device)


def make_llama_train_step(
    cfg: llama.LlamaConfig,
    optimizer: Optional[OptimizerFactory] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> TrainStepBundle:
    """Llama (models.llama) on `device` and its train step; see
    `_make_train_step`."""
    return _make_train_step(llama, cfg, optimizer, generator, device)


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

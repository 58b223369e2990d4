"""The RL stack's actor-critic networks as plain functions over a tree.

Counterpart of ray_tpu/rllib/models.py. A module is an (init, apply) pair
of functions over a parameter tree {"pi": [{"w", "b"}, ...], "vf": [...]}
of tensors, the reference's layout, so the same apply runs in the rollout
runner (CPU tensors) and in the learner's update (on the card), and
weights move between the two as a tree of numpy arrays.

Random draws take an explicit torch.Generator; they cannot reproduce
jax.random's bits, so the tests carry the reference's weights across
with models/common.py's `params_from_jax` instead.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """fn applied to every leaf of a tree of dicts and lists, dict keys in
    sorted order as JAX orders a pytree's (so two trees with the same keys
    have their leaves in the same order, however their dicts were built)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, in tree_map's order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors → the same tree of numpy arrays on the host, each
    a copy (as jax.device_get hands out): a later in-place update of the
    tensors does not reach them."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def host_tensor(a) -> torch.Tensor:
    """A tensor as it is, or a numpy array as a CPU tensor sharing its
    memory (a copy of a read-only one, as jax.device_get hands out:
    torch has no read-only tensors)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.require(a, requirements="W"))


def params_to(tree: Any, device) -> Any:
    """A tree of numpy arrays or tensors → tensors on `device` (writable
    numpy arrays on the CPU share their memory)."""
    return tree_map(lambda a: host_tensor(a).to(device), tree)


def mlp_actor_critic_init(
    generator: torch.Generator,
    obs_dim: int,
    num_actions: int,
    hiddens: Sequence[int] = (64, 64),
    device="cuda",
) -> Dict[str, Any]:
    """Separate pi and vf MLPs, as the reference's: hidden weights normal ×
    √(2/d_in), the last layer normal × 0.01 (a near-uniform policy and
    near-zero values), biases 0, all f32. Drawn on the generator's device
    in the order pi then vf, layer by layer, then moved to `device`."""
    params: Dict[str, Any] = {}
    for head, out_dim in (("pi", num_actions), ("vf", 1)):
        sizes = [obs_dim, *hiddens]
        layers = []
        for din, dout in zip(sizes[:-1], sizes[1:]):
            w = torch.randn(din, dout, generator=generator,
                            device=generator.device) * np.sqrt(2.0 / din)
            layers.append({"w": w, "b": torch.zeros(dout)})
        w = torch.randn(sizes[-1], out_dim, generator=generator,
                        device=generator.device) * 0.01
        layers.append({"w": w, "b": torch.zeros(out_dim)})
        params[head] = layers
    return tree_map(lambda t: t.to(device, torch.float32), params)


def _mlp_forward(layers, x: torch.Tensor) -> torch.Tensor:
    for layer in layers[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


def mlp_actor_critic_apply(
    params: Dict[str, Any], obs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_dim] → (logits [B, A], value [B])."""
    logits = _mlp_forward(params["pi"], obs)
    value = _mlp_forward(params["vf"], obs)[..., 0]
    return logits, value


# --------------------------------------------------------------------------- #
# Categorical action distribution
# --------------------------------------------------------------------------- #

def categorical_sample(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max, as jax.random.categorical: argmax(logits + Gumbel noise),
    the uniform draw kept above the smallest normal float."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def categorical_logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)

"""Llama in PyTorch, parameter-compatible with ray_tpu/models/llama.py.

The decoder recipe of the JAX model: RMSNorm (pre-norm, no biases), SwiGLU
MLP, rotary position embeddings (HF's rotate-half layout), grouped-query
attention and an untied LM head. Parameters keep the JAX package's names,
shapes and stacked-layer layout (`wq` [L, D, H, hd], `wo` [L, H, hd, D]),
so `params_from_jax` carries a JAX tree over 1:1; they are stored in
`param_dtype` (f32) and cast to the compute dtype (bf16) at use.

Rounding follows the JAX model: RMSNorm normalizes in f32, casts to the
compute dtype and only then multiplies by its scale; RoPE's angles and
products are f32, then rounded. GQA repeats each kv head in place
(h0, h0, h1, h1: `repeat_interleave`, as `jnp.repeat`), because the flash
kernels take k and v with q's head count.

Attention (`attention_impl`): "auto" and "pallas" go through
ops.attention.flash_attention (the Hopper kernels for a CUDA input, their
plain versions for a CPU input); "xla" is the JAX model's plain einsum
path. `remat`: True, "dots" or False, as GPT-2's. `scan_layers` and the
`attn_block_*` fields are kept for parity and have no effect here.

Over a device mesh's tp axis (parallel/tensor.py, entered by the train
step) a rank holds H/tp query heads, KH/tp kv heads (the group count H/KH
is unchanged, and each local kv head is repeated in place as before),
F/tp SwiGLU columns and V/tp rows of `wte` and columns of `lm_head`: wq,
wk, wv, w_gate and w_up are column-parallel, wo and w_down row-parallel;
the embedding, the head and the loss are vocab-parallel, so under a mesh
`forward` returns this rank's logits [B, S, V/tp]. Over cp a rank holds a
contiguous S/cp chunk of every sequence: RoPE's positions start at its
global offset (cp_index · S/cp), and "auto" runs attention as a ring over
the cp group (ops/ring_attention.py) on the kv heads repeated to H;
under a mesh "pallas" and "xla" gather k and v over the cp group at KH
heads, repeat them to H only then, and attend from this rank's chunk of
the queries (ops/gathered_attention.py), as the reference's GSPMD gathers
them. Over pp the model runs no pipeline, as the reference's does not
(its rule table leaves the layer stack unsharded): every pp rank holds
every layer and the same rows, and the train step treats pp as a replica
axis.

`params_from_hf` maps a transformers `LlamaForCausalLM` that the caller
built or loaded; this module never imports transformers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.common import (  # params_from_jax: a JAX tree → torch
    ParamsModule, causal_attention, layers, params_from_jax, round_up,
    run_block,
)
from ray_tpu_torch.ops.cross_entropy import vocab_parallel_xent
from ray_tpu_torch.parallel.mesh import current_mesh, seq_offset
from ray_tpu_torch.parallel.tensor import (
    column_in, row_out, vocab_parallel_embed, vocab_parallel_logits,
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    seq_len: int = 2048
    n_layer: int = 22
    n_head: int = 32
    n_kv_head: int = 8            # grouped-query attention
    d_model: int = 2048
    d_ff: int = 5632              # SwiGLU hidden
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: Any = False            # False | True | "dots"
    attention_impl: str = "auto"  # auto | xla | pallas
    scan_layers: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 512

    def __post_init__(self):
        if self.n_head % self.n_kv_head:
            raise ValueError(
                f"n_head={self.n_head} must be divisible by "
                f"n_kv_head={self.n_kv_head}"
            )
        if self.d_model % self.n_head:
            raise ValueError("d_model must be divisible by n_head")
        if self.attention_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if not (isinstance(self.remat, bool) or self.remat == "dots"):
            raise ValueError(
                f"remat must be True, False, or 'dots'; got {self.remat!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 128)


def llama_tiny(**overrides) -> LlamaConfig:
    """Test-size config (hd 16: a CPU config; the kernels take hd 64, 128)."""
    return replace(
        LlamaConfig(vocab_size=256, seq_len=128, n_layer=2, n_head=4,
                    n_kv_head=2, d_model=64, d_ff=176),
        **overrides,
    )


def llama_1b(**overrides) -> LlamaConfig:
    """TinyLlama-1.1B shape (with the reference's n_kv_head 8)."""
    return replace(LlamaConfig(), **overrides)


def llama_7b(**overrides) -> LlamaConfig:
    return replace(
        LlamaConfig(n_layer=32, n_head=32, n_kv_head=32, d_model=4096,
                    d_ff=11008, seq_len=4096),
        **overrides,
    )


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #

def logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Each parameter's logical axis names, as the JAX model's: the
    sharding rules (parallel/sharding.py) map them to mesh axes."""
    blocks = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "heads", "kv"),
        "wv": ("layers", "embed", "heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    return {
        "wte": ("vocab", "embed"),
        "blocks": blocks,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def _param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    D, H, KH, hd = cfg.d_model, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    F_, L, V = cfg.d_ff, cfg.n_layer, cfg.padded_vocab
    return {
        "wte": (V, D),
        "blocks": {
            "attn_norm": (L, D),
            "wq": (L, D, H, hd),
            "wk": (L, D, KH, hd),
            "wv": (L, D, KH, hd),
            "wo": (L, H, hd, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, F_),
            "w_up": (L, D, F_),
            "w_down": (L, F_, D),
        },
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def init(
    cfg: LlamaConfig, generator: torch.Generator, device="cuda",
) -> Dict[str, Any]:
    """The JAX init's distribution (not its numbers: the generators differ):
    N(0, 0.02), the residual projections wo and w_down N(0, 0.02/sqrt(2L)),
    norm scales 1. Random numbers are drawn on the generator's device, then
    moved."""
    std = 0.02
    resid_std = std / math.sqrt(2 * cfg.n_layer)
    stds = {"wte": std, "wq": std, "wk": std, "wv": std, "wo": resid_std,
            "w_gate": std, "w_up": std, "w_down": resid_std, "lm_head": std}

    def make(name, shape):
        if name in stds:
            x = torch.randn(
                shape, generator=generator, device=generator.device,
                dtype=torch.float32,
            ).mul_(stds[name])
            return x.to(device=device, dtype=cfg.param_dtype)
        return torch.ones(shape, dtype=cfg.param_dtype, device=device)

    shapes = _param_shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "blocks"}
    params["blocks"] = {k: make(k, s) for k, s in shapes["blocks"].items()}
    return params


def param_count(cfg: LlamaConfig) -> int:
    """Parameters of the model, from their shapes (nothing is allocated)."""
    shapes = _param_shapes(cfg)
    leaves = [s for k, s in shapes.items() if k != "blocks"]
    leaves += list(shapes["blocks"].values())
    return sum(math.prod(s) for s in leaves)


class Llama(ParamsModule):
    """Llama as an nn.Module over the JAX-layout parameters."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def _rmsnorm(x, scale, eps):
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF-llama convention: x [..., S, hd] with the head
    dim split as [first half, second half] (rotate_half), not interleaved."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[:, None].float() * freqs[None, :]  # [S, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(q, k, v, cfg: LlamaConfig):
    """q [B, H, S, hd], k and v [B, KH, S, hd] → [B, H, S, hd], causal
    (under cp, this rank's chunk of the sequence; the kv heads repeated to
    H, after the gather on the gathered path: models.common.
    causal_attention)."""
    return causal_attention(q, k, v, cfg.attention_impl)


def _heads(h, w, dt):
    """h [B, S, D] · w [D, heads, hd] → [B, heads, S, hd]."""
    B, S, D = h.shape
    _, n, hd = w.shape
    return (h @ w.to(dt).reshape(D, n * hd)).view(B, S, n, hd).transpose(1, 2)


def _block(x, p: Dict[str, torch.Tensor], positions, cfg: LlamaConfig):
    """One decoder block. x: [B, S, D]; the heads and SwiGLU columns are
    those of the weights given (this rank's shares under tp)."""
    mesh = current_mesh()
    B, S, D = x.shape
    dt = cfg.dtype
    h = column_in(_rmsnorm(x, p["attn_norm"], cfg.rms_eps), mesh)
    q = _rope(_heads(h, p["wq"], dt), positions, cfg.rope_theta)
    k = _rope(_heads(h, p["wk"], dt), positions, cfg.rope_theta)
    v = _heads(h, p["wv"], dt)
    attn = _attention(q, k, v, cfg).transpose(1, 2).reshape(B, S, -1)
    x = x + row_out(attn @ p["wo"].to(dt).reshape(-1, D), mesh)
    h = column_in(_rmsnorm(x, p["mlp_norm"], cfg.rms_eps), mesh)
    gate = F.silu(h @ p["w_gate"].to(dt))
    up = h @ p["w_up"].to(dt)
    return x + row_out((gate * up) @ p["w_down"].to(dt), mesh)


def _trunk(params: Dict[str, Any], tokens, cfg: LlamaConfig):
    """tokens [B, S] int → final hidden states [B, S, D] (compute dtype)."""
    wte = params["wte"]
    tokens = torch.as_tensor(tokens, device=wte.device).long()
    mesh = current_mesh()
    x = vocab_parallel_embed(wte, tokens, mesh, cfg.dtype)
    S = tokens.shape[1]
    positions = seq_offset(mesh, S) + torch.arange(S, device=wte.device)
    for layer in layers(params["blocks"]):
        x = run_block(_block, cfg.remat, x, layer, positions, cfg)
    return _rmsnorm(x, params["final_norm"], cfg.rms_eps)


def forward(params: Dict[str, Any], tokens, cfg: LlamaConfig) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, padded_vocab] (compute dtype);
    under a mesh this rank's [B, S, padded_vocab / tp]."""
    x = _trunk(params, tokens, cfg)
    return vocab_parallel_logits(x, params["lm_head"].to(cfg.dtype),
                                 current_mesh())


def loss_terms(params: Dict[str, Any], tokens, targets, cfg: LlamaConfig):
    """(Σ nll over the targets >= 0, f32, through the fused softmax_xent on
    the full logits, or vocab_parallel_xent on this rank's under a mesh;
    0, the model having no auxiliary loss): `loss_fn` before its division
    by the count, which a meshed train step takes over the global batch."""
    logits = forward(params, tokens, cfg)
    targets = torch.as_tensor(targets, device=logits.device).long()
    return vocab_parallel_xent(logits, targets, current_mesh()).sum(), 0.0


def loss_fn(
    params: Dict[str, Any], tokens, targets, cfg: LlamaConfig,
) -> torch.Tensor:
    """Mean next-token cross-entropy over targets >= 0, f32 scalar."""
    total, _ = loss_terms(params, tokens, targets, cfg)
    targets = torch.as_tensor(targets, device=total.device)
    return total / (targets >= 0).sum().clamp(min=1)


def flops_per_token(cfg: LlamaConfig) -> float:
    """Training FLOPs per token (6N + attention), the JAX package's formula."""
    n = param_count(cfg)
    attn = 12 * cfg.n_layer * cfg.d_model * cfg.seq_len
    return 6.0 * n + attn


# --------------------------------------------------------------------------- #
# HF interop
# --------------------------------------------------------------------------- #

def params_from_hf(hf_model, cfg: LlamaConfig, device="cuda") -> Dict[str, Any]:
    """A transformers LlamaForCausalLM's state dict → this module's tree:
    HF's [out, in] weights transposed and reshaped to (D, H, hd), the vocab
    padded to a multiple of 128 with zero rows, the layers stacked."""
    sd = {k: v.detach().float().cpu() for k, v in hf_model.state_dict().items()}
    D, H, KH, hd = cfg.d_model, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    F_, V = cfg.d_ff, cfg.padded_vocab

    def pad_vocab(w):  # [v, D] → [V, D]
        out = torch.zeros((V, w.shape[1]), dtype=w.dtype)
        out[: w.shape[0]] = w
        return out

    # ours: (HF's name in a layer, the shape HF's [out, in] weight takes
    # transposed; None for a norm's scale)
    hf_names = {
        "attn_norm": ("input_layernorm.weight", None),
        "wq": ("self_attn.q_proj.weight", (D, H, hd)),
        "wk": ("self_attn.k_proj.weight", (D, KH, hd)),
        "wv": ("self_attn.v_proj.weight", (D, KH, hd)),
        "wo": ("self_attn.o_proj.weight", (H, hd, D)),
        "mlp_norm": ("post_attention_layernorm.weight", None),
        "w_gate": ("mlp.gate_proj.weight", (D, F_)),
        "w_up": ("mlp.up_proj.weight", (D, F_)),
        "w_down": ("mlp.down_proj.weight", (F_, D)),
    }

    def layer_weight(i, name, shape):
        w = sd[f"model.layers.{i}.{name}"]
        return w if shape is None else w.T.reshape(shape)

    def put(t):
        return t.to(device=device, dtype=cfg.param_dtype)

    blocks = {
        k: put(torch.stack([layer_weight(i, name, shape)
                            for i in range(cfg.n_layer)]))
        for k, (name, shape) in hf_names.items()
    }
    return {
        "wte": put(pad_vocab(sd["model.embed_tokens.weight"])),
        "blocks": blocks,
        "final_norm": put(sd["model.norm.weight"]),
        "lm_head": put(pad_vocab(sd["lm_head.weight"]).T.contiguous()),
    }

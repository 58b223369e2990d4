"""GPT-2 in PyTorch, parameter-compatible with ray_tpu/models/gpt2.py.

Parameters keep the JAX package's names, shapes and stacked-layer layout
(e.g. `qkv_w` [L, D, 3, H, hd], head-major), so `params_from_jax` carries a
JAX parameter tree over 1:1. They are stored in `param_dtype` (f32) and
cast to the compute dtype (bf16) at use, as the JAX model does.

Attention (`attention_impl`):
- "auto" and "pallas": ops.attention.flash_attention — the Hopper kernel
  for a CUDA input, its plain version for a CPU input;
- "xla": the plain einsum path of the JAX model (bf16 logits, masked with
  finfo(dtype).min, f32 softmax);
- "ring": ops.ring_attention.ring_attention over the mesh's cp process
  group, which "auto" also takes under a mesh with cp > 1; "ring" needs a
  mesh (a cp group of one runs the ring of one chunk);
- under a mesh, "pallas" and "xla" gather k and v over the cp group and
  attend from this rank's chunk of the queries
  (ops.gathered_attention, as the reference's GSPMD does), through the
  flash kernels or the plain path (models.common.attention_path).

Training: `loss_fn` is the mean next-token cross-entropy, through the
fused `ops.cross_entropy.softmax_xent` or, with `loss_chunk`, chunk by
chunk under `torch.utils.checkpoint` (the full [B, S, V] logits never
exist at once). `remat`: True checkpoints each block (its activations are
recomputed in the backward), "dots" saves only the matrix products'
outputs (selective checkpointing, as jax.checkpoint_policies.
checkpoint_dots does), False saves everything.

MoE (moe_experts > 0): every block's MLP is `ops.moe.moe_mlp` over E
experts with top-k routing; the blocks carry (x, aux) and the summed
load-balancing loss joins `loss_fn` as moe_aux_coeff · aux. The expert
parameters sit under blocks["moe"], stacked [L, E, ...].

Over a device mesh (parallel/mesh.py, entered by the train step):
`logical_axes` names each parameter's dims for the sharding rules; the
MoE layer holds E/ep experts a rank and counts capacity over the global
batch; with pp > 1 the blocks run as a GPipe pipeline over the pp group
(parallel/pipeline.py), each rank holding its stage's layers, and only the
last stage computes the head and the loss (MoE blocks are refused with pp,
as the JAX model refuses them). Over tp (parallel/tensor.py) a rank holds
H/tp heads, F/tp MLP columns (of every expert, with MoE) and V/tp rows of
wte, and a block takes its widths from those shards: qkv and fc are
column-parallel, proj and out row-parallel with their biases added after
the sum; the embedding, the tied head and the loss are vocab-parallel, so
under a mesh `forward` returns this rank's logits [B, S, V/tp]
(parallel.tensor.gather_vocab puts them together). Over cp a rank holds
a contiguous S/cp chunk of every sequence: its position embedding is
wpe[off : off + S/cp] (off = cp_index · S/cp), taken before a pipeline's
first stage, and attention runs as a ring over the cp group (or gathers k
and v, above), inside each pipeline stage too: a stage's cp ranks run
the same ticks, so their exchanges pair up.

`scan_layers` and the `attn_*block*` fields are kept for parity and have
no effect here: the forward runs eagerly, layer by layer, and the kernels'
tiles are fixed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.common import (  # params_from_jax: a JAX tree → torch
    ParamsModule, causal_attention, layers, params_from_jax, round_up,
    run_block,
)
from ray_tpu_torch.ops.cross_entropy import vocab_parallel_xent
from ray_tpu_torch.ops.moe import (
    moe_init, moe_logical_axes, moe_mlp, moe_param_shapes,
)
from ray_tpu_torch.parallel.mesh import axis_size, current_mesh, seq_offset
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stages_from_layers
from ray_tpu_torch.parallel.tensor import (
    column_in, row_out, vocab_parallel_embed, vocab_parallel_logits,
)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    seq_len: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: Any = False
    attention_impl: str = "auto"  # auto | xla | pallas | ring
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_bwd_block_q: int = 0
    attn_bwd_block_k: int = 0
    attn_block_h: int = 1
    attn_bwd_block_h: int = 0
    use_bias: bool = True
    scan_layers: bool = True
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01
    pipeline_microbatches: int = 0
    loss_chunk: Optional[int] = 0

    def __post_init__(self):
        if self.dropout:
            raise NotImplementedError(
                "dropout is not implemented; pretraining runs use dropout=0"
            )
        if self.attention_impl not in ("auto", "xla", "pallas", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if not (isinstance(self.remat, bool) or self.remat == "dots"):
            raise ValueError(
                f"remat must be True, False, or 'dots'; got {self.remat!r}"
            )
        if self.moe_experts < 0:
            raise ValueError("moe_experts must be >= 0")
        if self.moe_experts > 0:
            if not (1 <= self.moe_top_k <= self.moe_experts):
                raise ValueError(
                    f"moe_top_k={self.moe_top_k} must be in "
                    f"[1, moe_experts={self.moe_experts}]"
                )
            if self.moe_capacity_factor <= 0:
                raise ValueError("moe_capacity_factor must be > 0")
        if self.loss_chunk and self.seq_len % self.loss_chunk:
            raise ValueError(
                f"loss_chunk={self.loss_chunk} must divide seq_len="
                f"{self.seq_len} (or be 0 to disable chunked cross-entropy)"
            )

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_head:
            raise ValueError("d_model must be a multiple of n_head")
        return self.d_model // self.n_head

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 128)


def gpt2_124m(**overrides) -> GPT2Config:
    return replace(GPT2Config(), **overrides)


def gpt2_350m(**overrides) -> GPT2Config:
    return replace(
        GPT2Config(n_layer=24, n_head=16, d_model=1024), **overrides
    )


def gpt2_tiny(**overrides) -> GPT2Config:
    """Test-size config."""
    return replace(
        GPT2Config(vocab_size=512, seq_len=128, n_layer=2, n_head=4, d_model=128),
        **overrides,
    )


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #

def logical_axes(cfg: GPT2Config) -> Dict[str, Any]:
    """Each parameter's logical axis names (the tree of `init`), as the JAX
    model's: the sharding rules map them to mesh axes."""
    blocks = {
        "ln1_scale": ("layers", "embed"),
        "ln1_bias": ("layers", "embed"),
        "qkv_w": ("layers", "embed", None, "heads", "kv"),
        "qkv_b": ("layers", None, "heads", "kv"),
        "proj_w": ("layers", "heads", "kv", "embed"),
        "proj_b": ("layers", "embed"),
        "ln2_scale": ("layers", "embed"),
        "ln2_bias": ("layers", "embed"),
        "fc_w": ("layers", "embed", "mlp"),
        "fc_b": ("layers", "mlp"),
        "out_w": ("layers", "mlp", "embed"),
        "out_b": ("layers", "embed"),
    }
    if cfg.moe_experts > 0:
        for key in ("fc_w", "fc_b", "out_w", "out_b"):
            del blocks[key]
        blocks["moe"] = moe_logical_axes()
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": blocks,
        "lnf_scale": ("embed",),
        "lnf_bias": ("embed",),
    }


def _param_shapes(cfg: GPT2Config) -> Dict[str, Any]:
    D, H, hd, Fd, L = cfg.d_model, cfg.n_head, cfg.head_dim, cfg.d_ff, cfg.n_layer
    blocks = {
        "ln1_scale": (L, D),
        "ln1_bias": (L, D),
        "qkv_w": (L, D, 3, H, hd),
        "qkv_b": (L, 3, H, hd),
        "proj_w": (L, H, hd, D),
        "proj_b": (L, D),
        "ln2_scale": (L, D),
        "ln2_bias": (L, D),
        "fc_w": (L, D, Fd),
        "fc_b": (L, Fd),
        "out_w": (L, Fd, D),
        "out_b": (L, D),
    }
    if cfg.moe_experts > 0:
        # the dense MLP is replaced wholesale, as in the JAX model
        for key in ("fc_w", "fc_b", "out_w", "out_b"):
            del blocks[key]
        blocks["moe"] = moe_param_shapes(L, D, Fd, cfg.moe_experts)
    return {
        "wte": (cfg.padded_vocab, D),
        "wpe": (cfg.seq_len, D),
        "blocks": blocks,
        "lnf_scale": (D,),
        "lnf_bias": (D,),
    }


def init(
    cfg: GPT2Config, generator: torch.Generator, device="cuda",
) -> Dict[str, Any]:
    """GPT-2 initialization: N(0, 0.02), residual projections scaled
    1/sqrt(2L), wpe N(0, 0.01), LayerNorm scales 1 and every bias 0 — the
    JAX init's distribution (not its numbers: the generators differ).
    Random numbers are drawn on the generator's device, then moved. With
    moe_experts > 0 the dense MLP's parameters give way to `moe_init`'s
    under blocks["moe"]."""
    std = 0.02
    resid_std = std / math.sqrt(2 * cfg.n_layer)
    stds = {"wte": std, "wpe": 0.01, "qkv_w": std, "proj_w": resid_std,
            "fc_w": std, "out_w": resid_std}
    ones = ("ln1_scale", "ln2_scale", "lnf_scale")

    def make(name, shape):
        if name in stds:
            x = torch.randn(
                shape, generator=generator, device=generator.device,
                dtype=torch.float32,
            ).mul_(stds[name])
            return x.to(device=device, dtype=cfg.param_dtype)
        fill = torch.ones if name in ones else torch.zeros
        return fill(shape, dtype=cfg.param_dtype, device=device)

    shapes = _param_shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "blocks"}
    params["blocks"] = {k: make(k, s) for k, s in shapes["blocks"].items()
                        if k != "moe"}
    if cfg.moe_experts > 0:
        params["blocks"]["moe"] = moe_init(
            generator, cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.moe_experts,
            param_dtype=cfg.param_dtype, resid_std=resid_std, device=device,
        )
    return params


def param_count(cfg: GPT2Config) -> int:
    def count(shapes):
        return sum(count(s) if isinstance(s, dict) else math.prod(s)
                   for s in shapes.values())
    return count(_param_shapes(cfg))


class GPT2(ParamsModule):
    """GPT-2 as an nn.Module over the JAX-layout parameters."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def _layernorm(x, scale, bias, eps=1e-5):
    # f32 statistics for stability, cast back to compute dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _attention(q, k, v, cfg: GPT2Config):
    """q, k, v: [B, H, S, hd] → [B, H, S, hd], causal (under cp, this
    rank's chunk of the sequence; models.common.attention_path)."""
    return causal_attention(q, k, v, cfg.attention_impl)


def _block(x, p: Dict[str, Any], cfg: GPT2Config):
    """One transformer block. x: [B, S, D], or (x, aux) with MoE: the
    load-balancing loss accumulates through the layer carry. The head
    count and MLP width are those of the weights given (this rank's
    shares under tp)."""
    if cfg.moe_experts > 0:
        x, aux = x
    mesh = current_mesh()
    B, S, D = x.shape
    _, _, H, hd = p["qkv_w"].shape
    dt = cfg.dtype
    h = column_in(_layernorm(x, p["ln1_scale"], p["ln1_bias"]), mesh)
    # one [D, 3·H·hd] product; q, k, v come out head-major [B, H, S, hd]
    qkv = (h @ p["qkv_w"].to(dt).reshape(D, 3 * H * hd)).view(B, S, 3, H, hd)
    qkv = qkv + p["qkv_b"].to(dt)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    attn = _attention(q, k, v, cfg)
    attn = attn.transpose(1, 2).reshape(B, S, H * hd)
    proj = row_out(attn @ p["proj_w"].to(dt).reshape(H * hd, D), mesh)
    x = x + proj + p["proj_b"].to(dt)
    h = _layernorm(x, p["ln2_scale"], p["ln2_bias"])
    if cfg.moe_experts > 0:
        y, layer_aux = moe_mlp(
            h, p["moe"], top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, dtype=dt,
        )
        return x + y, aux + layer_aux
    h = column_in(h, mesh) @ p["fc_w"].to(dt) + p["fc_b"].to(dt)
    h = F.gelu(h, approximate="tanh")
    return x + row_out(h @ p["out_w"].to(dt), mesh) + p["out_b"].to(dt)


def _pipeline_stages(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, ("pp",))


def _last_stage(mesh) -> bool:
    """Whether this rank holds the model's head: always, unless it runs an
    earlier stage of a pipeline."""
    pp = _pipeline_stages(mesh)
    return pp == 1 or mesh.get_local_rank("pp") == pp - 1


def _blocks_pipelined(blocks, x, cfg: GPT2Config, mesh, pp: int):
    """The layer stack as a pp-stage GPipe pipeline over the mesh's pp
    group: `blocks` holds this rank's stage, L/pp layers."""
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "pipeline parallelism with MoE blocks is not supported yet "
            "(the aux-loss carry needs threading through the schedule); "
            "use a pp=1 mesh for MoE configs"
        )
    if cfg.n_layer % pp:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by pp={pp}")
    M = cfg.pipeline_microbatches or pp

    def stage_fn(stage, h):
        for layer in layers(stage):
            h = run_block(_block, cfg.remat, h, layer, cfg)
        return h

    return pipeline_apply(
        stage_fn, stages_from_layers(blocks, 1), x, num_stages=pp,
        num_microbatches=M, group=mesh.get_group("pp"),
    )


def _trunk(params: Dict[str, Any], tokens: torch.Tensor, cfg: GPT2Config):
    """tokens [B, S] int → (final hidden states [B, S, D] in the compute
    dtype, the MoE load-balancing loss summed over layers: f32, 0 when
    dense). Under a mesh with pp > 1 the hidden states hold only on the
    pipeline's last stage."""
    wte = params["wte"]
    tokens = torch.as_tensor(tokens, device=wte.device).long()
    S = tokens.shape[1]
    dt = cfg.dtype
    mesh = current_mesh()
    off = seq_offset(mesh, S)
    x = (vocab_parallel_embed(wte.to(dt), tokens, mesh)
         + params["wpe"][off:off + S].to(dt))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pp = _pipeline_stages(mesh)
    if pp > 1:
        x = _blocks_pipelined(params["blocks"], x, cfg, mesh, pp)
        return _layernorm(x, params["lnf_scale"], params["lnf_bias"]), aux
    if cfg.moe_experts > 0:
        x = (x, aux)    # thread the aux loss through the layers
    for layer in layers(params["blocks"]):
        x = run_block(_block, cfg.remat, x, layer, cfg)
    if cfg.moe_experts > 0:
        x, aux = x
    return _layernorm(x, params["lnf_scale"], params["lnf_bias"]), aux


def forward(params: Dict[str, Any], tokens, cfg: GPT2Config) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, padded_vocab] (compute dtype);
    under a mesh this rank's [B, S, padded_vocab / tp] (module
    docstring)."""
    x, _ = _trunk(params, tokens, cfg)
    # tied LM head
    return vocab_parallel_logits(x, params["wte"].to(cfg.dtype).T, current_mesh())


def _chunk_nll(x_c, targets_c, wte, mesh):
    """[B, c, D] hidden + [B, c] targets → sum nll for the chunk, through the
    vocab-parallel head and cross-entropy (the fused ones without a mesh).
    The mesh is an argument: the backward runs this again on the autograd
    engine's thread."""
    return vocab_parallel_xent(vocab_parallel_logits(x_c, wte.T, mesh),
                               targets_c, mesh).sum()


def loss_terms(params: Dict[str, Any], tokens, targets, cfg: GPT2Config):
    """(Σ nll over the targets >= 0, f32; moe_aux_coeff · the MoE
    load-balancing loss, 0 when dense): `loss_fn` before its division by
    the count, which a meshed train step takes over the global batch.
    targets [B, S] int (-1 = ignore).

    With loss_chunk = 0 (or one that does not divide S, or equals it) the
    LM head's logits go through the fused `softmax_xent` (under a mesh
    `vocab_parallel_xent`), whose backward
    keeps only the bf16 logits and a [B, S] lse. Otherwise the sequence is
    cut into chunks, each chunk's logits built and reduced to a scalar by
    the same head and cross-entropy and rebuilt in the backward
    (torch.utils.checkpoint): the full [B, S, V] logits never exist at
    once.

    On an earlier stage of a pipeline the head is not computed: the sum is
    a 0 that carries the stage's outputs into the backward."""
    x, moe_aux = _trunk(params, tokens, cfg)
    aux_term = cfg.moe_aux_coeff * moe_aux
    mesh = current_mesh()
    if not _last_stage(mesh):
        return x.float().mul(0).sum(), aux_term
    S = x.shape[1]
    targets = torch.as_tensor(targets, device=x.device).long()
    wte = params["wte"].to(cfg.dtype)
    chunk = cfg.loss_chunk or 0
    if chunk <= 0 or S % chunk or S == chunk:
        logits = vocab_parallel_logits(x, wte.T, mesh)
        return vocab_parallel_xent(logits, targets, mesh).sum(), aux_term
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        s = checkpoint(_chunk_nll, x[:, i:i + chunk], targets[:, i:i + chunk],
                       wte, mesh, use_reentrant=False)
        total = total + s
    return total, aux_term


def loss_fn(
    params: Dict[str, Any], tokens, targets, cfg: GPT2Config,
) -> torch.Tensor:
    """Mean next-token cross-entropy plus moe_aux_coeff times the MoE
    load-balancing loss (0 when dense), f32 scalar: `loss_terms`' sum over
    the count of targets >= 0."""
    total, aux_term = loss_terms(params, tokens, targets, cfg)
    count = (torch.as_tensor(targets, device=total.device) >= 0).sum()
    return total / count.clamp(min=1) + aux_term


def flops_per_token(cfg: GPT2Config) -> float:
    """Approximate training FLOPs per token (fwd+bwd ≈ 6N + attention term),
    the JAX package's formula. With MoE, N counts all E experts, though a
    token runs through k of them (and the card through E·C capacity slots
    per T tokens)."""
    n = param_count(cfg)
    attn = 12 * cfg.n_layer * cfg.d_model * cfg.seq_len  # 2*2*3 per token
    return 6.0 * n + attn

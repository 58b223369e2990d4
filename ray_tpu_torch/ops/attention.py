"""Flash attention: hand-written Hopper kernels and their plain versions.

Counterpart of ray_tpu/ops/attention.py. Two kernels replace the two
Pallas kernels there: csrc/flash_fwd.cu the forward `_fwd_kernel`, and
csrc/flash_bwd.cu the single-pass backward `_fused_bwd_kernel`.
`mha_forward_plain` and `mha_backward_plain` compute the same functions in
plain PyTorch. `_mha_forward_bhsd` and `_mha_backward_bhsd` send a CPU
tensor to the plain version and a CUDA tensor to the kernel, which raises
on what it does not take (anything but contiguous bf16 at hd 64 or 128):
there is no fallback from the card to the plain version.

Numerics follow the TPU kernels: the softmax scale is folded into q (and,
for dq, into k) in the input dtype, logits and the softmax state are f32,
the mask value is -1e30 from GLOBAL positions (q_offset, kv_offset), p is
cast to v's dtype before p.v and to do's before p^T.do, ds to q's before
both of its products, and a row with no visible key gets o = 0 and
lse = -1e30.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30  # mask value: large-negative, not -inf (exp() gives an exact 0)
KERNEL = "flash_fwd"  # csrc/flash_fwd.cu
BWD_KERNEL = "flash_bwd"  # csrc/flash_bwd.cu
_HEAD_DIMS = (64, 128)


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def mha_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int = 0, kv_offset: int = 0, *,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. q, k, v: [B, H, S, hd] on any
    device and dtype → (o [B, H, Sq, hd] in q's dtype, lse [B, H, Sq] f32)."""
    Sq, Skv = q.shape[2], k.shape[2]
    scale = _default_scale(q, scale)
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    visible = None
    if causal:
        rows = int(q_offset) + torch.arange(Sq, device=q.device)[:, None]
        cols = int(kv_offset) + torch.arange(Skv, device=q.device)[None, :]
        visible = rows >= cols
        s = s.masked_fill(~visible, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if visible is not None:
        # a row with no visible key has s == m == -1e30 and exp() == 1 there
        p = p.masked_fill(~visible, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    seen = l > 0
    l_safe = torch.where(seen, l, torch.ones_like(l))
    o = (acc / l_safe).to(q.dtype)
    lse = torch.where(seen, m + torch.log(l_safe), torch.full_like(m, _NEG_INF))
    return o, lse[..., 0]


def _entry(lib: ctypes.CDLL, symbol: str, n_pointers: int):
    """The C entry point `symbol` of a kernel library (`_build.load`):
    n_pointers pointers, then B, H, Sq, Skv, hd, q_off, kv_off, scale,
    causal and the stream."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v, q_offset, kv_offset, **like_q):
    """Raise on what the kernels do not take: q, k, v (and every tensor in
    `like_q`, shaped as q) must be contiguous, 16-byte aligned bf16
    [B, H, S, hd] tensors on one CUDA device, hd 64 or 128, S >= 1, and
    the offsets must fit in int32. Returns the offsets as ints."""
    named = (("q", q), ("k", k), ("v", v), *like_q.items())
    for name, x in named:
        if not x.is_cuda:
            raise ValueError(f"flash kernel: {name} is on {x.device}, not CUDA")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16; {name} is {x.dtype}")
        if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"flash kernel: {name} must be a contiguous, 16-byte aligned "
                f"[B, H, S, hd] tensor; got shape {tuple(x.shape)}"
            )
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    if (k.shape != (B, H, Skv, hd) or v.shape != k.shape
            or any(x.shape != q.shape for x in like_q.values())):
        raise ValueError(
            "flash kernel: shapes "
            + ", ".join(f"{n} {tuple(x.shape)}" for n, x in named)
            + " do not agree"
        )
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {hd} not in {_HEAD_DIMS}")
    if Sq < 1 or Skv < 1:
        raise ValueError("flash kernel: sequence lengths must be >= 1")
    if any(x.device != q.device for _, x in named):
        raise ValueError("flash kernel: inputs on different devices")
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    if max(abs(q_offset), abs(kv_offset)) >= 2 ** 30:
        raise ValueError("flash kernel: offsets must fit in int32")
    return q_offset, kv_offset


def mha_forward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int = 0, kv_offset: int = 0, *,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_fwd.cu. q, k, v: contiguous bf16 [B, H, S, hd] on
    one CUDA device, hd 64 or 128, any Sq, Skv >= 1. Raises on anything
    else. Counts each launch in `mha_forward_kernel.launches`."""
    q_offset, kv_offset = _check_kernel_inputs(q, k, v, q_offset, kv_offset)
    B, H, Sq, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _entry(_build.load(KERNEL), "flash_fwd_bf16", 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, Sq, k.shape[2], hd, q_offset, kv_offset,
        _default_scale(q, scale), int(causal), stream,
    )
    _build.check(err, "flash_fwd_bf16")
    mha_forward_kernel.launches += 1
    return o, lse


mha_forward_kernel.launches = 0


def _mha_forward_bhsd(
    q, k, v, q_offset=0, kv_offset=0, *, causal: bool, scale: Optional[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: [B, H, S, hd] → (o [B, H, S, hd], lse [B, H, S]). The plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return mha_forward_plain(
            q, k, v, q_offset, kv_offset, causal=causal, scale=scale
        )
    if q.device.type == "cuda":
        return mha_forward_kernel(
            q, k, v, q_offset, kv_offset, causal=causal, scale=scale
        )
    raise ValueError(f"flash attention: no path for device {q.device}")


# --------------------------------------------------------------------------- #
# Backward
# --------------------------------------------------------------------------- #

def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in f32, [B, H, Sq], for the plain version (the kernel
    computes it in its own prologue)."""
    return (do.float() * o.float()).sum(dim=-1)


def mha_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, q_offset: int = 0, kv_offset: int = 0,
    *, causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the explicit formula of
    the TPU kernel, not autograd of the forward. q, k, v, o, do [B, H, S, hd]
    on any device and dtype, lse [B, H, Sq] f32 → (dq, dk, dv) in the input
    dtypes. It rounds where the Pallas kernel rounds: qs = q·scale and
    k·scale in the input dtype, p cast to do's dtype before pᵀ·do, ds cast
    to q's dtype before dsᵀ·qs and ds·(k·scale), dq summed in f32.

    Masked entries of p are exactly 0. The Pallas kernel computes
    exp(−1e30 − lse) there, which is 0 too for a finite lse, the lse that
    causal attention and the ring pass give; for lse = −1e30 (a row with no
    visible key) it gives 1, so the two are held to each other only with a
    finite lse."""
    Sq, Skv = q.shape[2], k.shape[2]
    scale = _default_scale(q, scale)
    sc = torch.tensor(scale, dtype=q.dtype, device=q.device)
    qs = (q * sc).float()
    k_scaled = (k * sc.to(k.dtype)).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        rows = int(q_offset) + torch.arange(Sq, device=q.device)[:, None]
        cols = int(kv_offset) + torch.arange(Skv, device=q.device)[None, :]
        p = p.masked_fill(rows < cols, 0.0)
    dof = do.float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = (p * (dp - _delta(o, do)[..., None])).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, k_scaled)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_backward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, q_offset: int = 0, kv_offset: int = 0,
    *, causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_bwd.cu on the current stream. q, k, v, o, do:
    contiguous bf16 [B, H, S, hd] on one CUDA device, hd 64 or 128; lse:
    f32 [B, H, Sq]. Raises on anything else. One C call launches the
    prologue (delta = rowsum(do * o), dq's f32 accumulator zeroed), the main
    kernel (dq summed by bulk reduce-adds, whose order varies from run to
    run) and dq's cast to bf16; the wrapper only allocates outputs and
    scratch. Counts each call in `mha_backward_kernel.launches`."""
    q_offset, kv_offset = _check_kernel_inputs(
        q, k, v, q_offset, kv_offset, o=o, do=do
    )
    B, H, Sq, hd = q.shape
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(
            f"flash kernel: lse must be a contiguous f32 [B, H, Sq] tensor on "
            f"{q.device}; got {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    lib = _build.load(BWD_KERNEL)
    scratch = torch.empty(
        _scratch_bytes(lib)(B * H, Sq, hd) // 4, dtype=torch.float32,
        device=q.device,
    )
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _entry(lib, "flash_bwd_bf16", 10)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), B, H, Sq, k.shape[2], hd, q_offset, kv_offset,
        _default_scale(q, scale), int(causal), stream,
    )
    _build.check(err, "flash_bwd_bf16")
    mha_backward_kernel.launches += 1
    return dq, dk, dv


def _scratch_bytes(lib: ctypes.CDLL):
    """flash_bwd_scratch_bytes(B * H, Sq, hd) of csrc/flash_bwd.cu: the f32
    scratch one backward call needs (dq's accumulator, the lse and delta
    rows)."""
    fn = lib.flash_bwd_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return fn


mha_backward_kernel.launches = 0


def _mha_backward_bhsd(
    q, k, v, o, lse, do, q_offset=0, kv_offset=0, *,
    causal: bool, scale: Optional[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All tensors [B, H, S, hd], lse [B, H, S] → (dq, dk, dv). The plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return mha_backward_plain(
            q, k, v, o, lse, do, q_offset, kv_offset, causal=causal, scale=scale
        )
    if q.device.type == "cuda":
        return mha_backward_kernel(
            q, k, v, o, lse, do, q_offset, kv_offset, causal=causal, scale=scale
        )
    raise ValueError(f"flash attention: no path for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """[B, H, S, hd] flash attention with zero offsets. Saves (q, k, v, o,
    lse); its backward is the backward kernel on the card and the plain
    backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _mha_forward_bhsd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _mha_backward_bhsd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: Optional[float] = None, layout: str = "bshd",
) -> torch.Tensor:
    """Multi-head flash attention. q, k, v: [B, S, H, hd] → [B, S, H, hd]
    (layout="bshd") or [B, H, S, hd] in and out (layout="bhsd", the kernel's
    own layout). Inputs are made contiguous in [B, H, S, hd] before the kernel.

    The TPU tuning knobs of ray_tpu's flash_attention (block_q, block_k,
    bwd_block_q, bwd_block_k, block_h, bwd_block_h, interpret) are dropped:
    the Hopper kernel's tiles are fixed in its source.
    """
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown layout {layout!r}")
    bhsd = layout == "bhsd"
    q, k, v = (
        (x if bhsd else _to_bhsd(x)).contiguous() for x in (q, k, v)
    )
    o = _FlashAttention.apply(q, k, v, causal, _default_scale(q, scale))
    return o if bhsd else _to_bhsd(o)


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, kv_offset: int, *,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only flash attention with GLOBAL position offsets: q, k, v
    [B, S, H, hd] → (out [B, S, H, hd], lse [B, H, S] f32), the building
    block for merging attention over kv chunks by lse. Offsets are ints
    (or 0-d tensors). The TPU block sizes are dropped, as in flash_attention.
    """
    o, lse = _mha_forward_bhsd(
        _to_bhsd(q).contiguous(), _to_bhsd(k).contiguous(),
        _to_bhsd(v).contiguous(), int(q_offset), int(kv_offset),
        causal=causal, scale=_default_scale(q, scale),
    )
    return _to_bhsd(o), lse


def mha_backward_chunk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, q_offset: int, kv_offset: int, *,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward for one (q chunk, kv chunk) pair with GLOBAL offsets:
    q, k, v, o, do [B, S, H, hd], lse [B, H, Sq] the GLOBAL logsumexp over
    all kv chunks → this pair's (dq, dk, dv) contributions, [B, S, H, hd].
    The building block of ring attention's backward. The TPU block sizes
    are dropped, as in flash_attention."""
    dq, dk, dv = _mha_backward_bhsd(
        *(_to_bhsd(x).contiguous() for x in (q, k, v, o)), lse.contiguous(),
        _to_bhsd(do).contiguous(), int(q_offset), int(kv_offset),
        causal=causal, scale=_default_scale(q, scale),
    )
    return _to_bhsd(dq), _to_bhsd(dk), _to_bhsd(dv)

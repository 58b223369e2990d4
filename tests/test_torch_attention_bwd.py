"""Port vs JAX: flash-attention backward (ray_tpu_torch.ops.attention).

The same numpy inputs go through ray_tpu's Pallas backward
(`mha_backward_chunk`, interpret mode on the CPU, as
tests/test_flash_attention.py runs it) and the port's `mha_backward_plain`,
which is what a CPU tensor reaches; the kernel itself runs only on the
card (tests/test_torch_flash_kernel.py).

Tolerances: f32 at atol = rtol = 1e-4 — the two sum the products over q
and kv in other orders (gradients here are of order 1). bf16 at
atol = 3e-2 relative to each gradient's max-abs — both round p, ds and the
scaled q and k to bf16 at the same places, so they differ by the f32
summation order before the last rounding, a step or two of bf16 (2**-8
relative). The lse is the forward's own, so it is finite (global).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 3e-2


def inputs(seed, B=1, S=128, H=2, hd=32, Skv=None):
    """q, do [B, S, H, hd]; k, v [B, Skv, H, hd] (numpy f32)."""
    rng = np.random.default_rng(seed)
    Skv = Skv or S
    q, do = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, H, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def jax_forward(q, k, v, q_off, kv_off, causal, dtype):
    o, lse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), q_off, kv_off,
        causal=causal, block_q=32, block_k=32, interpret=True,
    )
    return np.array(o.astype(jnp.float32)), np.array(lse)


def both_backward(q, k, v, o, lse, do, q_off, kv_off, causal, dtype_name):
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    ref = jattn.mha_backward_chunk(
        *(jnp.asarray(x, jdt) for x in (q, k, v, o)), jnp.asarray(lse),
        jnp.asarray(do, jdt), q_off, kv_off, causal=causal,
        block_q=32, block_k=32, interpret=True,
    )
    out = tattn.mha_backward_chunk(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, o)),
        torch.from_numpy(lse), torch.from_numpy(do).to(tdt), q_off, kv_off,
        causal=causal,
    )
    return ([t.float().numpy() for t in out],
            [np.asarray(r.astype(jnp.float32)) for r in ref])


def assert_close(out, ref, dtype_name):
    for name, t, r in zip(("dq", "dk", "dv"), out, ref):
        if dtype_name == "float32":
            np.testing.assert_allclose(t, r, **F32_TOL, err_msg=name)
        else:
            err = np.abs(t - r).max() / np.abs(r).max()
            assert err <= BF16_REL, (name, err)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,S", [(True, 128), (False, 128), (True, 96)],
                         ids=["causal", "noncausal", "causal-S96"])
def test_backward_matches_jax(dtype_name, causal, S):
    # S = 96 is not a power of two: JAX halves its block to 32, the port's
    # kernel masks the ragged tail of its 64-row tiles
    q, k, v, do = inputs(0, S=S)
    # the forward in the working dtype gives o and lse, as training does
    o, lse = jax_forward(q, k, v, 0, 0, causal, getattr(jnp, dtype_name))
    out, ref = both_backward(q, k, v, o, lse, do, 0, 0, causal, dtype_name)
    assert_close(out, ref, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_offset_chunks_with_global_lse_match_jax_and_sum_to_full(dtype_name):
    """The second half of the queries against two kv chunks at global
    offsets 0 and 64, each with the GLOBAL lse of full causal attention:
    each pair's gradients match JAX's, and dq summed over the chunks, dk
    and dv stacked, equal the full backward's second-half rows."""
    S, half = 128, 64
    q, k, v, do = inputs(1, S=S)
    o, lse = jax_forward(q, k, v, 0, 0, True, getattr(jnp, dtype_name))
    qh, oh, doh, lseh = q[:, half:], o[:, half:], do[:, half:], lse[..., half:]
    dq_sum = 0
    parts = []
    for off in (0, half):
        kc, vc = k[:, off:off + half], v[:, off:off + half]
        out, ref = both_backward(qh, kc, vc, oh, lseh, doh, half, off, True,
                                 dtype_name)
        assert_close(out, ref, dtype_name)
        dq_sum = dq_sum + out[0]
        parts.append(out)
    # the full causal backward restricted to q rows [64, 128): its dk/dv
    # contributions come from those rows only, so pass do = 0 elsewhere
    do_tail = do.copy()
    do_tail[:, :half] = 0
    full, _ = both_backward(q, k, v, o, lse, do_tail, 0, 0, True, dtype_name)
    dk_cat = np.concatenate([parts[0][1], parts[1][1]], axis=1)
    dv_cat = np.concatenate([parts[0][2], parts[1][2]], axis=1)
    assert_close([dq_sum, dk_cat, dv_cat],
                 [full[0][:, half:], full[1], full[2]], dtype_name)


def test_backward_plain_equals_autograd_of_forward_plain():
    """In f32 the explicit formula equals autograd of the plain forward."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2).contiguous()
                   for x in inputs(3, S=80, hd=64))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = tattn.mha_forward_plain(*qkv, causal=True)
    grads = torch.autograd.grad(o, qkv, do)
    out = tattn.mha_backward_plain(q, k, v, o.detach(), lse.detach(), do,
                                   causal=True)
    for a, b in zip(out, grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bf16_backward_rounds_like_the_tpu_kernel():
    """In bf16 the plain backward must equal the Pallas arithmetic written
    out: qs and k·scale in bf16, p and ds cast to bf16 before the products,
    f32 sums."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2).contiguous().bfloat16()
                   for x in inputs(4, S=64, hd=64))
    o, lse = tattn.mha_forward_plain(q, k, v, causal=True)
    dq, dk, dv = tattn.mha_backward_plain(q, k, v, o, lse, do, causal=True)
    sc = torch.tensor(0.125, dtype=torch.bfloat16)
    qs, ks = (q * sc).float(), (k * sc).float()
    s = qs @ k.float().transpose(-1, -2)
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - lse[..., None])
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (do.float() @ v.float().transpose(-1, -2) - delta)).bfloat16().float()
    torch.testing.assert_close(
        dv, (p.bfloat16().float().transpose(-1, -2) @ do.float()).bfloat16(),
        atol=0, rtol=0)
    torch.testing.assert_close(dk, (ds.transpose(-1, -2) @ qs).bfloat16(),
                               atol=0, rtol=0)
    torch.testing.assert_close(dq, (ds @ ks).bfloat16(), atol=0, rtol=0)

"""Port vs JAX, in one process with no process group: gathered attention
(ray_tpu_torch.ops.gathered_attention) and the MoE layer's queue over the
(batch, sequence) token order, chunk by chunk.

Gathered attention: `virtual_gathered_attention` runs cp chunks of q
against k and v joined over the chunks, each chunk's queries at their
global offset, with grouped-query kv heads (H 4 over KH 2) repeated after
the gather. It is held to the reference's whole-sequence attention on the
same seeded numpy inputs, the kv heads repeated as its Llama repeats them
(jnp.repeat): "pallas" to ray_tpu/ops/attention.py's flash_attention (its
Pallas kernels in interpret mode), "xla" to ray_tpu/models/gpt2.py's
einsum path. The limits are the ring tests' (tests/test_torch_ring_
attention.py): in f32 the forward 2e-5 and the gradients of Σ sin(o)
5e-4; in bf16 the "pallas" forward 2**-7 absolute (each side rounds p and
o to bf16 once, against its own maxima). The bf16 "xla" forward is held
to 3e-2 absolute, tests/test_torch_gpt2.py's bf16 limit: both sides round
the logits q·kᵀ to bf16 before the scale, at hd 128 values near 40 where
a bf16 step is 0.25 (0.022 after the scale), so a sum that rounds the
other way moves a probability by 2 % and o by up to that; the port's
whole-sequence "xla" path is 0.0117 from the reference's on these inputs,
the gathered one the same.

The queue: the routing of each (batch rank, cp chunk) block of a batch,
moved to global places by ops/moe.py's `_queue` from every block's counts
(what `_global_queue` all-gathers over the mesh), must give the places and
drops of the whole batch routed at once, and, through the experts, the
reference's moe_mlp output on the whole batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.models.common import attention_path
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.ops.gathered_attention import virtual_gathered_attention

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_TOL = {"pallas": dict(atol=2 ** -7, rtol=0), "xla": dict(atol=3e-2, rtol=0)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, H, KH, S = 1, 4, 2, 128


def make_qkv(hd: int):
    """q [B, H, S, hd], k and v [B, KH, S, hd], f32 numpy."""
    rng = np.random.default_rng(hd)
    return [rng.standard_normal((B, n, S, hd)).astype(np.float32)
            for n in (H, KH, KH)]


@functools.lru_cache(maxsize=None)
def jax_attention(impl: str, dtype: str, hd: int):
    """The reference's whole-sequence output (f32 numpy) and the gradients
    of Σ sin(o) with respect to q, k and v (at KH heads)."""
    jdt = DTYPES[dtype][0]

    def loss(q, k, v):
        k, v = (jnp.repeat(x, H // KH, axis=1) for x in (k, v))
        if impl == "pallas":
            o = jattn.flash_attention(q, k, v, causal=True, layout="bhsd",
                                      block_q=32, block_k=32, interpret=True)
        else:
            o = jgpt2._attention(q, k, v, jgpt2.gpt2_tiny(attention_impl="xla"))
        return jnp.sum(jnp.sin(o.astype(jnp.float32))), o

    args = [jnp.asarray(x).astype(jdt) for x in make_qkv(hd)]
    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(*args)
    return (np.asarray(o.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_virtual_gathered_attention_matches_jax(impl, cp, dtype, hd):
    """The chunks' outputs, joined, against the reference's whole-sequence
    attention; in f32 also each chunk's gradients of Σ sin(o), joined."""
    tdt = DTYPES[dtype][1]
    chunks = [[c.contiguous().requires_grad_(True)
               for c in torch.from_numpy(x).to(tdt).chunk(cp, 2)]
              for x in make_qkv(hd)]
    outs = virtual_gathered_attention(*chunks, impl=impl)
    assert all(o.dtype == tdt and o.shape == (B, H, S // cp, hd) for o in outs)
    o = torch.cat([x.detach() for x in outs], 2).float().numpy()
    ref_o, ref_grads = jax_attention(impl, dtype, hd)
    if dtype == "bf16":
        np.testing.assert_allclose(o, ref_o, **BF16_TOL[impl])
        return
    np.testing.assert_allclose(o, ref_o, **FWD_TOL)
    sum(x.float().sin().sum() for x in outs).backward()
    for name, cs, want in zip("qkv", chunks, ref_grads):
        got = torch.cat([c.grad for c in cs], 2).numpy()
        np.testing.assert_allclose(got, want, **BWD_TOL, err_msg=f"d{name}")


def test_gathered_attention_refuses_other_impls():
    q = [torch.zeros(1, 2, 4, 8)]
    with pytest.raises(ValueError, match="gathered attention runs"):
        virtual_gathered_attention(q, q, q, impl="ring")


def test_attention_path_dispatch():
    """"pallas" and "xla" gather under any mesh, a cp group of one
    included, as "ring" rings under any; "auto" rings only under cp > 1;
    without a mesh the flash kernels or the plain path, and "ring"
    raises."""
    paths = {(impl, cp): attention_path(impl, cp)
             for impl in ("auto", "pallas", "xla", "ring") for cp in (1, 2)}
    assert paths == {("auto", 1): "flash", ("auto", 2): "ring",
                     ("pallas", 1): "gathered", ("pallas", 2): "gathered",
                     ("xla", 1): "gathered", ("xla", 2): "gathered",
                     ("ring", 1): "ring", ("ring", 2): "ring"}
    assert [attention_path(i, None) for i in ("auto", "pallas", "xla")] == [
        "flash", "flash", "plain"]
    with pytest.raises(ValueError, match="needs a mesh with a cp axis"):
        attention_path("ring", None)


def moe_inputs(B_, S_, D, F, E, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, S_, D)).astype(np.float32)
    p = {"router_w": rng.standard_normal((D, E)),
         "fc_w": rng.standard_normal((E, D, F)) * 0.3,
         "fc_b": rng.standard_normal((E, F)) * 0.1,
         "out_w": rng.standard_normal((E, F, D)) * 0.3,
         "out_b": rng.standard_normal((E, D)) * 0.1}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("batch_ranks,cp", [(1, 2), (2, 2), (1, 4), (2, 4)])
def test_queue_chunk_by_chunk_matches_the_whole_batch(batch_ranks, cp):
    """Each (batch rank, chunk) block routed alone, moved to its global
    places by `_queue` from every block's counts: the places and drops of
    the whole batch routed at once (capacity factor 0.5, so choices are
    dropped and the order decides which), and the layer's output built
    from them the reference's moe_mlp output on the whole batch (f32)."""
    B_, S_, D, F, E, k = 4, 32, 8, 16, 4, 2
    x, p = moe_inputs(B_, S_, D, F, E)
    xt = torch.from_numpy(x)
    w = torch.from_numpy(p["router_w"])
    C = tmoe.moe_capacity(B_ * S_, E, k, 0.5)
    whole = tmoe.route(xt.reshape(-1, D), w, k, C)
    rows, Sc = B_ // batch_ranks, S_ // cp
    blocks = {(b, c): tmoe.route(
        xt[b * rows:(b + 1) * rows, c * Sc:(c + 1) * Sc].reshape(-1, D), w, k, C)
        for b in range(batch_ranks) for c in range(cp)}
    every = torch.stack([torch.stack([tmoe._choice_counts(blocks[b, c], rows)
                                      for c in range(cp)])
                         for b in range(batch_ranks)])
    pos = torch.empty(B_, S_, k, dtype=torch.long)
    keep = torch.empty(B_, S_, k, dtype=torch.bool)
    for (b, c), r in blocks.items():
        g = tmoe._queue(r, C, every, b, c)
        where = (slice(b * rows, (b + 1) * rows), slice(c * Sc, (c + 1) * Sc))
        pos[where] = g.pos.view(rows, Sc, k)
        keep[where] = g.keep.view(rows, Sc, k)
    assert torch.equal(pos.view(-1, k), whole.pos)
    assert torch.equal(keep.view(-1, k), whole.keep)
    assert not whole.keep.all() and whole.keep.any()

    # y = Σ over kept choices of gate · expert(x), every expert on every token
    pt = {n: torch.from_numpy(v) for n, v in p.items()}
    h = torch.nn.functional.gelu(
        torch.einsum("td,edf->tef", xt.reshape(-1, D), pt["fc_w"]) + pt["fc_b"],
        approximate="tanh")
    out = torch.einsum("tef,efd->ted", h, pt["out_w"]) + pt["out_b"]
    chosen = out.gather(1, whole.expert[..., None].expand(-1, k, D))
    y = (chosen * (whole.gate * keep.view(-1, k))[..., None]).sum(1)
    ref, _ = jmoe.moe_mlp(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
                          top_k=k, capacity_factor=0.5, dtype=jnp.float32)
    np.testing.assert_allclose(y.view(B_, S_, D).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)

"""Port vs JAX: ring attention (ray_tpu_torch.ops.ring_attention) against
ray_tpu/ops/ring_attention.py, the ports of tests/test_ring_attention.py.

The same seeded numpy q, k, v [B, S, H, hd] go through the reference's
`ring_attention_sharded` on the virtual CPU mesh (its Pallas kernels in
interpret mode) and through the port's ring on the flash kernels' plain
versions: the virtual ring (`virtual_ring_attention`, all cp chunks in
this process) and the real one (`ring_attention` over a gloo cp group in 4
processes of tests/torch_parallel_ranks.py). Tolerances are the reference
test's: forward 2e-5, the gradients of Σ sin(o) 5e-4, in f32. In bf16 the
forward is held to 2**-7 absolute: the reference kernel rounds p to bf16
against the running max of its 32-key blocks, the port's plain version
against the row max, and each rounds o once, so o may differ by a bf16
step (2**-8 near 1; |o| < 1 here). The two shortcuts of the port's
schedule (the accumulators start from the first chunk; a chunk wholly in
the causal future is not launched) are held bitwise to the schedule
without them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import ring_attention as jring
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.ops import ring_attention as tring
from test_torch_parallel_train import run_ranks

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_TOL = dict(atol=2 ** -7, rtol=0)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def make_qkv(seed, B=2, S=256, H=4, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


def jax_mesh(spec, devices):
    return jmesh.make_mesh(spec, devices[:spec.num_devices])


def jax_ring(qkv, mesh, causal, dtype=jnp.float32):
    """The reference's output (f32 numpy) and the gradients of Σ sin(o)."""
    def loss(q, k, v):
        o = jring.ring_attention_sharded(q, k, v, mesh, causal=causal,
                                         block_q=32, block_k=32)
        return jnp.sum(jnp.sin(o.astype(jnp.float32))), o

    args = [jnp.asarray(x).astype(dtype) for x in qkv]
    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(*args)
    return (np.asarray(o.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def port_chunks(qkv, cp, dtype=torch.float32):
    """[B, S, H, hd] numpy → cp chunks of each of q, k, v, [B, H, S/cp, hd],
    leaves that require grad."""
    return [[c.contiguous().requires_grad_(True) for c in
             torch.from_numpy(x).to(dtype).transpose(1, 2).chunk(cp, 2)]
            for x in qkv]


def joined(chunks):
    """cp chunks [B, H, S/cp, hd] → [B, S, H, hd] f32 numpy."""
    return torch.cat([c.detach() for c in chunks], 2).transpose(1, 2).float().numpy()


def test_merge_matches_jax():
    """_merge against the reference's on rows with both partials set, with
    lse −1e30 on one side (a chunk with no visible key: its weight is 0)
    and on both (the output stays 0)."""
    rng = np.random.default_rng(0)
    B, H, S, hd = 2, 3, 8, 4
    o1, o2 = (rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(2))
    lse1, lse2 = (rng.uniform(-3, 3, (B, H, S)).astype(np.float32) for _ in range(2))
    lse1[:, :, 1] = -1e30
    lse2[:, :, 2] = -1e30
    lse1[:, :, 3] = lse2[:, :, 3] = -1e30
    o1[:, :, 3] = o2[:, :, 3] = 0
    o, lse = tring._merge(*(torch.from_numpy(x) for x in (o1, lse1, o2, lse2)))
    jo, jlse = jring._merge(*(jnp.asarray(x) for x in (
        o1.swapaxes(1, 2), lse1, o2.swapaxes(1, 2), lse2)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).swapaxes(1, 2),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(o[:, :, 1].numpy(), o2[:, :, 1])
    np.testing.assert_array_equal(o[:, :, 2].numpy(), o1[:, :, 2])
    assert not o[:, :, 3].any() and (lse[:, :, 3] == -1e30).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cp", [2, 4])
def test_virtual_ring_forward_matches_jax(cpu_mesh8, cp, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    qkv = make_qkv(0)
    mesh = jax_mesh(jmesh.MeshSpec.for_devices(8, cp=cp), cpu_mesh8)
    ref, _ = jax_ring(qkv, mesh, causal, jdt)
    out = tring.virtual_ring_attention(*port_chunks(qkv, cp, tdt), causal=causal)
    assert all(o.dtype == tdt for o in out)
    np.testing.assert_allclose(joined(out), ref,
                               **(FWD_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("cp", [2, 4])
def test_virtual_ring_backward_matches_jax(cpu_mesh8, cp):
    qkv = make_qkv(1, B=1, S=128, H=2)
    mesh = jax_mesh(jmesh.MeshSpec.for_devices(8, cp=cp), cpu_mesh8)
    _, ref = jax_ring(qkv, mesh, True)
    qs, ks, vs = port_chunks(qkv, cp)
    out = tring.virtual_ring_attention(qs, ks, vs, causal=True)
    torch.cat(out, 2).sin().sum().backward()
    for name, chunks, want in zip("qkv", (qs, ks, vs), ref):
        np.testing.assert_allclose(joined([c.grad for c in chunks]), want,
                                   **BWD_TOL, err_msg=f"d{name}")


def unshortened(qs, ks, vs, dos, causal):
    """The reference's schedule literally, on the plain versions: every
    chunk pair launched, the accumulators started from (0, −1e30) and from
    zeros. Returns (outputs, (dq, dk, dv) per chunk)."""
    from ray_tpu_torch.ops.attention import mha_backward_plain, mha_forward_plain

    n, S = len(qs), qs[0].shape[2]
    outs, lses, grads = [], [], []
    for r in range(n):
        o = torch.zeros(qs[r].shape, dtype=torch.float32)
        lse = torch.full(qs[r].shape[:3], -1e30)
        for step in range(n):
            src = (r - step) % n
            o_c, lse_c = mha_forward_plain(qs[r], ks[src], vs[src], r * S,
                                           src * S, causal=causal)
            o, lse = tring._merge(o, lse, o_c.float(), lse_c)
        outs.append(o.to(qs[r].dtype))
        lses.append(lse)
    dq = [torch.zeros(q.shape) for q in qs]
    dk = [torch.zeros(k.shape) for k in ks]
    dv = [torch.zeros(v.shape) for v in vs]
    for step in range(n):
        for r in range(n):
            src = (r - step) % n
            g = mha_backward_plain(qs[r], ks[src], vs[src], outs[r], lses[r],
                                   dos[r], r * S, src * S, causal=causal)
            dq[r] = dq[r] + g[0].float()
            dk[src] = dk[src] + g[1].float()
            dv[src] = dv[src] + g[2].float()
    grads = [(a.to(q.dtype), b.to(q.dtype), c.to(q.dtype))
             for a, b, c, q in zip(dq, dk, dv, qs)]
    return outs, grads


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cp", [2, 4])
def test_shortcuts_are_exact(cp, causal, dtype):
    """The port's schedule (accumulators from the first chunk, future
    chunks skipped) against the reference's without either: the same
    outputs and gradients, bitwise (torch.equal)."""
    tdt = DTYPES[dtype][1]
    qkv = make_qkv(2, B=1, S=64, H=2, hd=16)
    qs, ks, vs = port_chunks(qkv, cp, tdt)
    dos = [torch.randn(q.shape, generator=torch.Generator().manual_seed(i)).to(tdt)
           for i, q in enumerate(qs)]
    out = tring.virtual_ring_attention(qs, ks, vs, causal=causal)
    got = torch.autograd.grad(out, qs + ks + vs, dos)
    want_out, want = unshortened(*(
        [x.detach() for x in chunks] for chunks in (qs, ks, vs)), dos, causal)
    for a, b in zip(out, want_out):
        assert torch.equal(a, b)
    for r in range(cp):
        for name, i in zip("qkv", range(3)):
            assert torch.equal(got[i * cp + r], want[r][i]), (name, r)


@pytest.mark.parametrize("causal,launches", [(True, [1, 2, 3, 4]),
                                             (False, [4, 4, 4, 4])])
def test_launches_follow_the_formula(monkeypatch, causal, launches):
    """cp rank r launches each kernel r + 1 times under a causal mask
    (never a kv chunk wholly in its future), cp times without; every launch
    at the chunks' global offsets."""
    calls = {"fwd": [], "bwd": []}

    def counting(kind, fn):
        def wrapped(q, *args, causal, scale):
            q_off, kv_off = args[-2:]
            calls[kind].append((q_off, kv_off))
            return fn(q, *args, causal=causal, scale=scale)
        return wrapped

    for kind, name in (("fwd", "_mha_forward_bhsd"), ("bwd", "_mha_backward_bhsd")):
        monkeypatch.setattr(tring, name, counting(kind, getattr(tring, name)))
    qs, ks, vs = port_chunks(make_qkv(3, B=1, S=64, H=2, hd=16), 4)
    torch.cat(tring.virtual_ring_attention(qs, ks, vs, causal=causal), 2).sum().backward()
    for kind in ("fwd", "bwd"):
        by_rank = [sum(q_off == 16 * r for q_off, _ in calls[kind]) for r in range(4)]
        assert by_rank == launches, (kind, by_rank)
        assert sum(launches) == (10 if causal else 16)
        assert all(kv_off <= q_off or not causal for q_off, kv_off in calls[kind])


# The real ring: 4 gloo ranks, each with its block of the same global
# q, k, v (rows over dp·fsdp, positions over cp, heads over tp).
RING_PLANS = [
    {"kind": "ring", "name": "ring_cp4", "mesh": {"cp": 4}, "causal": True},
    {"kind": "ring", "name": "ring_cp4_full", "mesh": {"cp": 4}, "causal": False},
    # the reference's test_ring_with_sharded_inputs: batch and sequence split
    {"kind": "ring", "name": "ring_fsdp2cp2", "mesh": {"fsdp": 2, "cp": 2},
     "causal": True},
    {"kind": "ring", "name": "ring_cp2tp2", "mesh": {"cp": 2, "tp": 2},
     "causal": True},
]


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ranks")
    devices = jax.devices("cpu")
    refs = {}
    for i, plan in enumerate(RING_PLANS):
        qkv = make_qkv(10 + i, B=4, S=128)
        np.savez(workdir / f"{plan['name']}.npz", **dict(zip("qkv", qkv)))
        mesh = jax_mesh(jmesh.MeshSpec(**plan["mesh"]), devices)
        refs[plan["name"]] = jax_ring(qkv, mesh, plan["causal"])
    return refs, run_ranks(workdir, RING_PLANS)


@pytest.mark.parametrize("name", [p["name"] for p in RING_PLANS])
def test_ring_over_gloo_matches_jax(ring_runs, name):
    """Each rank's block of the output and of the gradients, put in its
    place, against the reference on the same MeshSpec; each rank ran
    (cp − 1) rotations forward and cp backward over cp, nothing else."""
    (ref_o, ref_grads), ranks = ring_runs[0][name], ring_runs[1][name]
    got = {n: np.full_like(ref_o, np.nan) for n in ("o", "dq", "dk", "dv")}
    cp = {p["name"]: p for p in RING_PLANS}[name]["mesh"]["cp"]
    for out, meta in ranks:
        block = tuple(slice(*meta[n]) for n in ("rows", "cols", "heads"))
        for n in got:
            got[n][block] = out[n]
        assert meta["collectives"] == {"cp": 2 * cp - 1}, meta["collectives"]
    assert not any(np.isnan(a).any() for a in got.values())
    np.testing.assert_allclose(got["o"], ref_o, **FWD_TOL)
    for n, want in zip(("dq", "dk", "dv"), ref_grads):
        np.testing.assert_allclose(got[n], want, **BWD_TOL, err_msg=n)

"""Port vs JAX: GPT-2 loss and gradients, the optimizer chain and the
training step (ray_tpu_torch.models.gpt2.loss_fn, ray_tpu_torch.train).

The JAX parameters of `gpt2_tiny` are carried over with `params_from_jax`
and the same numpy batches go through both packages. The port's attention
"auto" (the flash plain versions on the CPU, forward and backward) is
paired with JAX "pallas" (the Pallas kernels in interpret mode), "xla"
with "xla".

Tolerances: float32 losses at atol 1e-5 and gradients at 1e-5 relative to
each leaf's max-abs (the frameworks sum in other orders; measured about
1e-6); bfloat16 gradients at 3e-2 relative (the frameworks round the
activations to bf16 at different places; measured 1.4e-2). Optimizer
moments are stored in bf16, so they agree within one bf16 step (2**-8
relative); params within 1e-5 after 3 f32 training steps (measured 2e-6:
Adam's first steps move each weight by about the learning rate, whatever
the gradient's size, so a tiny gradient that differs in sign moves a
weight the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import mesh as mesh_lib
from ray_tpu.train import train_step as jtrain
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.train import train_step as ttrain

IMPL_PAIRS = [("auto", "pallas"), ("xla", "xla")]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jgpt2.init(jgpt2.gpt2_tiny(),
                                               jax.random.PRNGKey(0)))


def pairs(ref, out, prefix=""):
    """(name, reference leaf, port leaf) over a parameter tree, by key."""
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from pairs(v, out[k], prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v, np.float32), out[k]


def assert_tree_close(ref, out, rel, label=""):
    for name, r, t in pairs(ref, out):
        err = np.abs(t.detach().float().numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= rel, (label, name, err)


def loss_and_grads(jax_params, batch, dtype_name, torch_impl, jax_impl, chunk):
    jcfg = jgpt2.gpt2_tiny(dtype=getattr(jnp, dtype_name),
                           attention_impl=jax_impl, loss_chunk=chunk)
    tcfg = tgpt2.gpt2_tiny(dtype=getattr(torch, dtype_name),
                           attention_impl=torch_impl, loss_chunk=chunk)
    jloss, jgrads = jax.jit(jax.value_and_grad(jgpt2.loss_fn), static_argnums=3)(
        jax_params, batch["tokens"], batch["targets"], jcfg)
    params = tgpt2.params_from_jax(jax_params, device="cpu")
    for p in ttrain.param_leaves(params):
        p.requires_grad_(True)
    loss = tgpt2.loss_fn(params, batch["tokens"], batch["targets"], tcfg)
    loss.backward()
    grads = {k: (v.grad if not isinstance(v, dict)
                 else {kk: vv.grad for kk, vv in v.items()})
             for k, v in params.items()}
    return float(jloss), loss, jax.device_get(jgrads), grads


@pytest.mark.parametrize("torch_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("chunk", [0, 32])
def test_loss_and_grads_match_jax(jax_params, chunk, torch_impl, jax_impl):
    batch = jtrain.synthetic_batch(jgpt2.gpt2_tiny(), 2, seed=0)
    jloss, loss, jgrads, grads = loss_and_grads(
        jax_params, batch, "float32", torch_impl, jax_impl, chunk)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - jloss) <= 1e-5
    assert_tree_close(jgrads, grads, 1e-5)


def test_bf16_loss_and_grads_match_jax(jax_params):
    batch = jtrain.synthetic_batch(jgpt2.gpt2_tiny(), 2, seed=1)
    jloss, loss, jgrads, grads = loss_and_grads(
        jax_params, batch, "bfloat16", "auto", "pallas", 0)
    assert abs(float(loss.detach()) - jloss) <= 1e-3
    assert_tree_close(jgrads, grads, 3e-2)


def test_loss_chunk_equals_fused_path():
    cfg = tgpt2.gpt2_tiny(dtype=torch.float32)
    params = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = ttrain.synthetic_batch(cfg, 2, seed=2)
    batch["targets"][0, :50] = -1
    losses = [tgpt2.loss_fn(params, batch["tokens"], batch["targets"],
                            tgpt2.gpt2_tiny(dtype=torch.float32, loss_chunk=c))
              for c in (0, 32)]
    torch.testing.assert_close(losses[0], losses[1], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_same_gradients(remat):
    batch = ttrain.synthetic_batch(tgpt2.gpt2_tiny(), 2, seed=3)
    grads = []
    for r in (False, remat):
        cfg = tgpt2.gpt2_tiny(remat=r)
        params = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = ttrain.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tgpt2.loss_fn(params, batch["tokens"], batch["targets"], cfg).backward()
        grads.append([p.grad for p in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flops_per_token_matches_jax():
    for make in ("gpt2_124m", "gpt2_tiny"):
        assert (tgpt2.flops_per_token(getattr(tgpt2, make)())
                == jgpt2.flops_per_token(getattr(jgpt2, make)()))


def test_schedule_matches_optax():
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000,
                                             end_value=3e-5)
    ours = ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000, 3e-5)
    for count in (0, 1, 2, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=0)
    assert ours(0) == 0.0


def test_optimizer_matches_optax_chain():
    """Three updates on fixed gradients (the first under the clip, the
    others over it), warmup 2: params and both bf16 moments match optax."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal((16,)).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.01, 1.0, 3.0)]

    opt = jtrain.default_optimizer(warmup=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttrain.default_optimizer(warmup=2, total_steps=10)(list(tp.values()))
    for i, g in enumerate(grads):
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
        assert float(topt.grad_norm) == pytest.approx(norm, rel=1e-6)
        if i == 0:   # lr = 0 at the first update
            for k in params:
                np.testing.assert_array_equal(tp[k].numpy(), params[k])
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-6)
            adam = jstate[1]
            for moment, ref in (("mu", adam.mu[k]), ("nu", adam.nu[k])):
                t = topt.state[tp[k]][moment]
                assert t.dtype == torch.bfloat16
                ref = np.asarray(ref.astype(jnp.float32))
                np.testing.assert_allclose(t.float().numpy(), ref, rtol=2 ** -8,
                                           atol=1e-30)
    assert topt.count == 3


def test_three_train_steps_match_jax():
    """3 steps of make_gpt2_train_step on gpt2_tiny (f32) against JAX's
    under single_device_mesh, from the same params: loss, grad_norm and
    params after the last step."""
    jcfg = jgpt2.gpt2_tiny(dtype=jnp.float32, attention_impl="pallas")
    tcfg = tgpt2.gpt2_tiny(dtype=torch.float32, attention_impl="auto")
    jb = jtrain.make_gpt2_train_step(
        jcfg, mesh=mesh_lib.single_device_mesh(),
        optimizer=jtrain.default_optimizer(warmup=2, total_steps=10),
        rng=jax.random.PRNGKey(0))
    tb = ttrain.make_gpt2_train_step(
        tcfg, optimizer=ttrain.default_optimizer(warmup=2, total_steps=10),
        device="cpu")
    start = tgpt2.params_from_jax(jax.device_get(jb.state["params"]), device="cpu")
    with torch.no_grad():
        for _, src, dst in pairs(start, tb.state["params"]):
            dst.copy_(torch.from_numpy(src))
    jstate, tstate = jb.state, tb.state
    for i in range(3):
        batch = jtrain.synthetic_batch(jcfg, 2, seed=i)
        jstate, jm = jb.step_fn(jstate, batch)
        tstate, tm = tb.step_fn(tstate, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-5)
    assert tstate["step"] == 3
    for name, ref, out in pairs(jax.device_get(jstate["params"]), tstate["params"]):
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_named_leaves_name_each_param_leaf(jax_params):
    """named_leaves walks the tree in param_leaves' order, and each name is
    the leaf's key path in the JAX package's tree."""
    params = tgpt2.params_from_jax(jax_params, device="cpu")
    named = list(ttrain.named_leaves(params))
    leaves = ttrain.param_leaves(params)
    assert len(leaves) == len(named)
    assert all(t is leaf for (_, t), leaf in zip(named, leaves))
    assert len({n for n, _ in named}) == len(named)
    for name, t in named:
        ref = jax_params
        for k in name.split("."):
            ref = ref[k]
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref, np.float32))


def test_multi_step_equals_repeated_step():
    cfg = tgpt2.gpt2_tiny(n_layer=1)
    batches = [ttrain.synthetic_batch(cfg, 2, seed=s) for s in (5, 6)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    a = ttrain.make_gpt2_train_step(
        cfg, optimizer=ttrain.default_optimizer(warmup=1), device="cpu")
    b = ttrain.make_gpt2_train_step(
        cfg, optimizer=ttrain.default_optimizer(warmup=1), device="cpu")
    losses = []
    for batch in batches:
        _, m = a.step_fn(a.state, batch)
        losses.append(m["loss"])
    _, metrics = b.multi_step_fn(b.state, stacked)
    assert metrics["loss"].shape == (2,) and metrics["grad_norm"].shape == (2,)
    torch.testing.assert_close(metrics["loss"], torch.stack(losses), atol=0, rtol=0)
    for p, q in zip(ttrain.param_leaves(a.state["params"]),
                    ttrain.param_leaves(b.state["params"])):
        torch.testing.assert_close(p, q, atol=0, rtol=0)


def test_loss_falls_on_a_repeated_batch():
    cfg = tgpt2.gpt2_tiny()
    bundle = ttrain.make_gpt2_train_step(
        cfg, optimizer=ttrain.default_optimizer(lr=1e-3, warmup=1), device="cpu")
    batch = ttrain.synthetic_batch(cfg, 2, seed=7)
    losses = [float(bundle.step_fn(bundle.state, batch)[1]["loss"])
              for _ in range(4)]
    assert losses[1] == losses[0]        # lr = 0 at the first update
    assert losses[-1] < losses[0] - 0.1

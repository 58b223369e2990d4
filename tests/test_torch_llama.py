"""Port vs JAX: Llama (ray_tpu_torch.models.llama) and its train step.

The JAX parameters are carried over with `params_from_jax` and the same
numpy tokens go through `ray_tpu.models.llama` and the port, at two
configurations: `llama_tiny` (hd 16, 2 kv heads for 4 query heads) and a
narrow one at the kernels' hd 64 with one kv head for 4 query heads
("gqa64": D 256, H 4, KH 1, L 2). The port's "auto" attention (the flash
plain versions on the CPU) is paired with JAX "pallas" (the Pallas kernels
in interpret mode), "xla" with "xla".

Tolerances:
- f32 logits at atol = rtol = 1e-4 (the frameworks sum in other orders;
  measured 2e-7 to 8e-7); bf16 logits at atol 3e-2, rtol 0 (logits lie
  within ±2, where a bf16 step is at most 2**-7, and the frameworks round
  intermediate products at different places; measured one step);
- f32 loss at atol 1e-5 and gradients at 1e-5 of each leaf's max-abs;
  bf16 gradients at 3e-2 of each leaf's max-abs (activations rounded to
  bf16 at different places, as for GPT-2);
- RMSNorm and RoPE alone at one bf16 step (2**-8 relative) in bf16, 1e-6
  in f32 (XLA's and PyTorch's rsqrt, cos and sin round differently);
- HF parity at atol = rtol = 2e-3, as tests/test_llama_model.py;
- three f32 train steps: loss 1e-5, grad norm 1e-5 relative, params 1e-5
  (as GPT-2's, tests/test_torch_train_step.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as mesh_lib
from ray_tpu.train import train_step as jtrain
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.train import train_step as ttrain
from ray_tpu_torch.train.batch_predictor import TorchPredictor
from ray_tpu_torch.train.checkpoint import Checkpoint

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=0)
IMPL_PAIRS = [("auto", "pallas"), ("xla", "xla")]
GQA64 = dict(d_model=256, n_head=4, n_kv_head=1, d_ff=512)
CONFIGS = {"tiny": {}, "gqa64": GQA64}


def configs(name, dtype_name="float32", torch_impl="auto", jax_impl="pallas",
            **extra):
    over = {**CONFIGS[name], **extra}
    return (jllama.llama_tiny(dtype=getattr(jnp, dtype_name),
                              attention_impl=jax_impl, **over),
            tllama.llama_tiny(dtype=getattr(torch, dtype_name),
                              attention_impl=torch_impl, **over))


@pytest.fixture(scope="module")
def jax_trees():
    return {name: jax.tree.map(np.asarray, jllama.init(
        configs(name)[0], jax.random.PRNGKey(i))) for i, name in enumerate(CONFIGS)}


def tokens(seed, B=2, S=128, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


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


@pytest.mark.parametrize("torch_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("dtype_name,tol", [("float32", F32_TOL),
                                            ("bfloat16", BF16_TOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(jax_trees, name, dtype_name, tol, torch_impl, jax_impl):
    jcfg, tcfg = configs(name, dtype_name, torch_impl, jax_impl)
    toks = tokens(0)
    ref = np.asarray(jllama.forward(jax_trees[name], jnp.asarray(toks), jcfg)
                     .astype(jnp.float32))
    out = tllama.forward(tllama.params_from_jax(jax_trees[name], device="cpu"),
                         torch.from_numpy(toks), tcfg)
    assert out.dtype == tcfg.dtype and out.shape == (2, 128, 256)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


def loss_and_grads(tree, batch, jcfg, tcfg):
    jloss, jgrads = jax.jit(jax.value_and_grad(jllama.loss_fn), static_argnums=3)(
        tree, batch["tokens"], batch["targets"], jcfg)
    params = tllama.params_from_jax(tree, device="cpu")
    for p in ttrain.param_leaves(params):
        p.requires_grad_(True)
    loss = tllama.loss_fn(params, batch["tokens"], batch["targets"], tcfg)
    loss.backward()
    grads = {k: (v.grad if not isinstance(v, dict)
                 else {kk: vv.grad for kk, vv in v.items()})
             for k, v in params.items()}
    return float(jloss), loss, jax.device_get(jgrads), grads


@pytest.mark.parametrize("torch_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(jax_trees, name, torch_impl, jax_impl):
    jcfg, tcfg = configs(name, "float32", torch_impl, jax_impl)
    batch = jtrain.synthetic_batch(jcfg, 2, seed=0)
    jloss, loss, jgrads, grads = loss_and_grads(jax_trees[name], batch, jcfg, tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - jloss) <= 1e-5
    assert_tree_close(jgrads, grads, 1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_loss_and_grads_match_jax(jax_trees, name):
    jcfg, tcfg = configs(name, "bfloat16")
    batch = jtrain.synthetic_batch(jcfg, 2, seed=1)
    jloss, loss, jgrads, grads = loss_and_grads(jax_trees[name], batch, jcfg, tcfg)
    assert abs(float(loss.detach()) - jloss) <= 1e-3
    assert_tree_close(jgrads, grads, 3e-2)


@pytest.mark.parametrize("dtype_name,rtol", [("float32", 1e-6),
                                             ("bfloat16", 2 ** -8)])
def test_rmsnorm_matches_jax(dtype_name, rtol):
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 16, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    ref = np.asarray(jllama._rmsnorm(jnp.asarray(x, jdt), jnp.asarray(scale), 1e-5)
                     .astype(jnp.float32))
    out = tllama._rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale), 1e-5)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("dtype_name,atol", [("float32", 1e-6),
                                             ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("hd", [16, 128])
def test_rope_matches_jax(dtype_name, atol, hd):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40, hd)).astype(np.float32)
    positions = np.arange(40) + 1000     # far positions: angles of many turns
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    ref = np.asarray(jllama._rope(jnp.asarray(x, jdt), jnp.asarray(positions), 1e4)
                     .astype(jnp.float32))
    out = tllama._rope(torch.from_numpy(x).to(tdt), torch.from_numpy(positions), 1e4)
    assert out.dtype == tdt
    # |x| < 5 here, so atol covers a rounding step of each output
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5 * atol, rtol=0)


def test_rope_rotates_halves_not_pairs():
    """Position 1 rotates the pair (x[i], x[i + hd/2]) by angle freq_i."""
    x = torch.zeros(1, 1, 2, 8)
    x[..., 0] = 1.0                      # first half, i = 0 (freq 1)
    out = tllama._rope(x, torch.arange(2), 1e4)
    c, s = np.cos(1.0), np.sin(1.0)
    np.testing.assert_allclose(out[0, 0, 1].numpy(),
                               [c, 0, 0, 0, s, 0, 0, 0], atol=1e-6)


def test_gqa_attention_repeats_each_kv_head_in_place():
    """KH < H: the port's _attention equals JAX's (jnp.repeat: h0, h0, h1,
    h1) on the same q, k, v, and differs from a tiled (h0, h1, h0, h1) k, v."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 32, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 32, 16)).astype(np.float32) for _ in range(2))
    jcfg, tcfg = configs("tiny", jax_impl="xla", torch_impl="xla")
    ref = np.asarray(jllama._attention(*map(jnp.asarray, (q, k, v)), jcfg))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = tllama._attention(tq, tk, tv, tcfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    flash = tllama._attention(tq, tk, tv, dataclasses.replace(tcfg, attention_impl="auto"))
    np.testing.assert_allclose(flash.numpy(), ref, atol=1e-5, rtol=1e-5)
    tiled = tllama._attention(tq, tk.repeat(1, 2, 1, 1), tv.repeat(1, 2, 1, 1),
                              dataclasses.replace(tcfg, n_kv_head=4))
    assert not torch.allclose(tiled, out, atol=1e-3)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gqa_equals_mha_with_repeated_kv_heads(jax_trees, name):
    """The port at KH < H gives the logits of the port at KH = H whose wk
    and wv repeat each kv head groups times in place."""
    _, tcfg = configs(name)
    params = tllama.params_from_jax(jax_trees[name], device="cpu")
    groups = tcfg.n_head // tcfg.n_kv_head
    mha = {**params, "blocks": {
        k: (w.repeat_interleave(groups, dim=2) if k in ("wk", "wv") else w)
        for k, w in params["blocks"].items()}}
    toks = torch.from_numpy(tokens(5, S=64))
    out = tllama.forward(params, toks, tcfg)
    ref = tllama.forward(mha, toks, dataclasses.replace(tcfg, n_kv_head=tcfg.n_head))
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("make", ["llama_tiny", "llama_1b", "llama_7b"])
def test_param_count_and_flops_match_jax(make):
    tcfg, jcfg = getattr(tllama, make)(), getattr(jllama, make)()
    assert tllama.param_count(tcfg) == jllama.param_count(jcfg)
    assert tllama.flops_per_token(tcfg) == jllama.flops_per_token(jcfg)
    for field in ("vocab_size", "seq_len", "n_layer", "n_head", "n_kv_head",
                  "d_model", "d_ff", "rope_theta", "rms_eps", "remat",
                  "attention_impl", "scan_layers", "attn_block_q", "attn_block_k"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.head_dim, tcfg.padded_vocab) == (jcfg.head_dim, jcfg.padded_vocab)


def test_logical_axes_match_jax():
    assert (tllama.logical_axes(tllama.llama_1b())
            == jllama.logical_axes(jllama.llama_1b()))


def test_params_from_jax_keeps_names_shapes_dtypes(jax_trees):
    tree = jax_trees["gqa64"]
    tp = tllama.params_from_jax(tree, device="cpu")
    assert tp.keys() == tree.keys() and tp["blocks"].keys() == tree["blocks"].keys()
    assert tuple(tp["blocks"]["wk"].shape) == (2, 256, 1, 64)
    for name, ref, t in pairs(tree, tp):
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)


def test_init_shapes_distribution_and_device():
    cfg = tllama.llama_tiny()
    p = tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: jllama.init(jllama.llama_tiny(),
                                                jax.random.PRNGKey(0)))
    for name, ref, t in pairs(jax.tree.map(lambda s: np.zeros(s.shape), shapes), p):
        assert tuple(t.shape) == ref.shape, name
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert abs(float(p["wte"].std()) - 0.02) < 2e-3
    assert abs(float(p["blocks"]["wo"].std()) - 0.01) < 1e-3   # 0.02 / sqrt(2 L)
    assert torch.all(p["blocks"]["attn_norm"] == 1) and torch.all(p["final_norm"] == 1)
    again = tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(p["lm_head"], again["lm_head"], atol=0, rtol=0)


def test_module_matches_functional_forward(jax_trees):
    _, cfg = configs("tiny")
    params = tllama.params_from_jax(jax_trees["tiny"], device="cpu")
    toks = torch.from_numpy(tokens(6, S=32))
    with torch.inference_mode():
        torch.testing.assert_close(tllama.Llama(cfg, params)(toks),
                                   tllama.forward(params, toks, cfg), atol=0, rtol=0)


def test_causality():
    cfg = tllama.llama_tiny(dtype=torch.float32)
    params = tllama.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    a = tokens(7, B=1, S=64)
    b = a.copy()
    b[0, 40] = (b[0, 40] + 1) % cfg.vocab_size
    la, lb = (tllama.forward(params, torch.from_numpy(x), cfg) for x in (a, b))
    torch.testing.assert_close(la[:, :40], lb[:, :40], atol=0, rtol=0)
    assert not torch.allclose(la[:, 40:], lb[:, 40:])


def test_config_rejects_what_the_model_cannot_run():
    with pytest.raises(ValueError, match="divisible"):
        tllama.llama_tiny(n_kv_head=3)
    with pytest.raises(ValueError, match="attention_impl"):
        tllama.llama_tiny(attention_impl="ring")
    with pytest.raises(ValueError, match="remat"):
        tllama.llama_tiny(remat="all")


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_same_gradients(remat):
    cfg0 = tllama.llama_tiny(**GQA64)
    batch = ttrain.synthetic_batch(cfg0, 2, seed=3)
    grads = []
    for r in (False, remat):
        cfg = dataclasses.replace(cfg0, remat=r)
        params = tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = ttrain.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tllama.loss_fn(params, batch["tokens"], batch["targets"], cfg).backward()
        grads.append([p.grad for p in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def hf_model(cfg):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layer,
        num_attention_heads=cfg.n_head, num_key_value_heads=cfg.n_kv_head,
        max_position_embeddings=cfg.seq_len, rms_norm_eps=cfg.rms_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hf_numerics_parity(name):
    """Logits match transformers' LlamaForCausalLM on identical weights
    (as tests/test_llama_model.py::test_hf_numerics_parity)."""
    _, cfg = configs(name)
    hf = hf_model(cfg)
    params = tllama.params_from_hf(hf, cfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
        ours = tllama.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(ours[:, :, :cfg.vocab_size].numpy(), ref,
                               rtol=2e-3, atol=2e-3)


def test_params_from_hf_equals_jax_params_from_hf():
    jcfg, tcfg = configs("gqa64")
    hf = hf_model(tcfg)
    ref = jax.tree.map(np.asarray, jllama.params_from_hf(hf, jcfg))
    out = tllama.params_from_hf(hf, tcfg, device="cpu")
    assert out.keys() == ref.keys() and out["blocks"].keys() == ref["blocks"].keys()
    for name, r, t in pairs(ref, out):
        assert t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), r, err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_train_steps_match_jax(name):
    """3 steps of make_llama_train_step (f32) against JAX's under
    single_device_mesh, from the same params: loss, grad_norm and params
    after the last step."""
    jcfg, tcfg = configs(name)
    jb = jtrain.make_llama_train_step(
        jcfg, mesh=mesh_lib.single_device_mesh(),
        optimizer=jtrain.default_optimizer(warmup=2, total_steps=10),
        rng=jax.random.PRNGKey(0))
    tb = ttrain.make_llama_train_step(
        tcfg, optimizer=ttrain.default_optimizer(warmup=2, total_steps=10),
        device="cpu")
    start = tllama.params_from_jax(jax.device_get(jb.state["params"]), device="cpu")
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
    for pname, ref, out in pairs(jax.device_get(jstate["params"]), tstate["params"]):
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0,
                                   err_msg=pname)


def test_predictor_round_trip_of_a_llama_checkpoint(jax_trees, tmp_path):
    """A directory Checkpoint of Llama params served by a TorchPredictor on
    the CPU answers as the forward on the same params does."""
    _, cfg = configs("gqa64")
    params = tllama.params_from_jax(jax_trees["gqa64"], device="cpu")

    def apply_fn(p, batch):
        logits = tllama.forward(p, batch["tokens"], cfg)[:, -1, :cfg.vocab_size]
        return {"next_token": logits.argmax(-1), "logits": logits}

    path = Checkpoint.from_dict({"params": params}).to_directory(str(tmp_path))
    pred = TorchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                          apply_fn=apply_fn, device="cpu")
    toks = ttrain.synthetic_batch(cfg, 2, seed=8)["tokens"]
    got = pred.predict({"tokens": toks})
    with torch.no_grad():
        want = apply_fn(params, {"tokens": torch.from_numpy(toks)})
    assert got["next_token"].shape == (2,)
    np.testing.assert_array_equal(got["next_token"], want["next_token"].numpy())
    np.testing.assert_array_equal(got["logits"], want["logits"].numpy())

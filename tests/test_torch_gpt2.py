"""Port vs JAX: GPT-2 forward (ray_tpu_torch.models.gpt2).

The JAX parameters of `gpt2_tiny` are carried over with `params_from_jax`
and the same numpy tokens go through `ray_tpu.models.gpt2.forward` and the
port's `forward`. Each port attention path is held against its JAX twin:
"auto" (the flash plain version on the CPU) against "pallas" (the Pallas
kernel in interpret mode), "xla" against "xla" (the einsum path that masks
with finfo(dtype).min).

Tolerances: float32 at atol = rtol = 1e-4 (the two frameworks sum in other
orders; measured about 7e-7); bfloat16 at atol = 3e-2, rtol = 0 — logits
lie in [-2, 2], where one bf16 step is 2**-7 = 0.0078, and the frameworks
round intermediate products at different places (measured one step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.train import train_step as jtrain
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.train import train_step as ttrain

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=0)
IMPL_PAIRS = [("auto", "pallas"), ("xla", "xla")]


@pytest.fixture(scope="module")
def jax_params():
    cfg = jgpt2.gpt2_tiny()
    return jax.tree.map(np.asarray, jgpt2.init(cfg, jax.random.PRNGKey(0)))


def tokens(seed, B=2, S=128, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def both_logits(jax_params, toks, dtype_name, torch_impl, jax_impl):
    jcfg = jgpt2.gpt2_tiny(dtype=getattr(jnp, dtype_name), attention_impl=jax_impl)
    tcfg = tgpt2.gpt2_tiny(dtype=getattr(torch, dtype_name),
                           attention_impl=torch_impl)
    ref = jgpt2.forward(jax_params, jnp.asarray(toks), jcfg)
    out = tgpt2.forward(tgpt2.params_from_jax(jax_params, device="cpu"),
                        torch.from_numpy(toks), tcfg)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("torch_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("dtype_name,tol", [("float32", F32_TOL),
                                            ("bfloat16", BF16_TOL)],
                         ids=["f32", "bf16"])
def test_logits_match_jax(jax_params, dtype_name, tol, torch_impl, jax_impl):
    out, ref = both_logits(jax_params, tokens(0), dtype_name, torch_impl,
                           jax_impl)
    assert out.shape == (2, 128, 512)
    np.testing.assert_allclose(out, ref, **tol)


def test_params_from_jax_keeps_names_shapes_dtypes(jax_params):
    tp = tgpt2.params_from_jax(jax_params, device="cpu")
    assert tp.keys() == jax_params.keys()
    assert tp["blocks"].keys() == jax_params["blocks"].keys()
    assert tuple(tp["blocks"]["qkv_w"].shape) == (2, 128, 3, 4, 32)
    for k, v in jax_params["blocks"].items():
        np.testing.assert_array_equal(tp["blocks"][k].numpy(), v)
        assert tp["blocks"][k].dtype == torch.float32


def test_module_matches_functional_forward(jax_params):
    cfg = tgpt2.gpt2_tiny()
    params = tgpt2.params_from_jax(jax_params, device="cpu")
    toks = torch.from_numpy(tokens(1, S=64))
    with torch.inference_mode():
        torch.testing.assert_close(tgpt2.GPT2(cfg, params)(toks),
                                   tgpt2.forward(params, toks, cfg),
                                   atol=0, rtol=0)


def test_causality():
    """Changing token t leaves the logits of every earlier position as they
    were (same check as tests/test_gpt2_model.py::test_causality)."""
    cfg = tgpt2.gpt2_tiny(dtype=torch.float32)
    params = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    a = tokens(2, B=1, S=64)
    b = a.copy()
    b[0, 40] = (b[0, 40] + 1) % cfg.vocab_size
    la, lb = (tgpt2.forward(params, torch.from_numpy(x), cfg) for x in (a, b))
    torch.testing.assert_close(la[:, :40], lb[:, :40], atol=0, rtol=0)
    assert not torch.allclose(la[:, 40:], lb[:, 40:])


def test_init_distribution_and_device():
    cfg = tgpt2.gpt2_tiny()
    p = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["wte"].shape == (cfg.padded_vocab, cfg.d_model)
    assert p["wte"].dtype == torch.float32 and p["wte"].device.type == "cpu"
    assert abs(float(p["wte"].std()) - 0.02) < 1e-3
    assert torch.all(p["blocks"]["ln1_scale"] == 1)
    assert torch.all(p["blocks"]["qkv_b"] == 0)
    again = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(p["blocks"]["fc_w"], again["blocks"]["fc_w"])


@pytest.mark.parametrize("make", ["gpt2_124m", "gpt2_350m", "gpt2_tiny"])
def test_param_count_matches_jax(make):
    assert (tgpt2.param_count(getattr(tgpt2, make)())
            == jgpt2.param_count(getattr(jgpt2, make)()))


def test_later_slices_raise_not_implemented():
    # ring attention came with the cp slice: it runs over a mesh's cp
    # group, and without a mesh it raises the reference's ValueError
    with pytest.raises(ValueError, match="needs a mesh with a cp axis"):
        cfg = tgpt2.gpt2_tiny(attention_impl="ring")
        tgpt2.forward(tgpt2.init(cfg, torch.Generator(), device="cpu"),
                      torch.zeros(1, 8, dtype=torch.long), cfg)
    # MoE blocks came with the ops/moe slice: init builds the moe subtree
    p = tgpt2.init(tgpt2.gpt2_tiny(moe_experts=4), torch.Generator(),
                   device="cpu")
    assert "fc_w" not in p["blocks"]
    assert {k: tuple(v.shape) for k, v in p["blocks"]["moe"].items()} == {
        "router_w": (2, 128, 4), "fc_w": (2, 4, 128, 512),
        "fc_b": (2, 4, 512), "out_w": (2, 4, 512, 128), "out_b": (2, 4, 128)}


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batch_identical_to_jax(seed):
    jb = jtrain.synthetic_batch(jgpt2.gpt2_tiny(), 4, seed=seed)
    tb = ttrain.synthetic_batch(tgpt2.gpt2_tiny(), 4, seed=seed)
    assert tb.keys() == jb.keys()
    for k in jb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])

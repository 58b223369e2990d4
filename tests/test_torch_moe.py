"""Port vs JAX: the mixture-of-experts layer (ray_tpu_torch.ops.moe) and
GPT-2 with MoE blocks (ray_tpu_torch.models.gpt2, moe_experts > 0).

The same numpy inputs (seeded) go through `ray_tpu.ops.moe.moe_mlp` and
the port's `moe_mlp` (index dispatch) and `moe_mlp_plain` (the reference's
dense einsums), and through `ray_tpu.models.gpt2` and the port's GPT-2
built from the same JAX parameters with `params_from_jax`. The first
three tests are tests/test_moe.py:14-83 run on the port.

Tolerances, relative to each reference's max-abs (the frameworks sum in
other orders):
- float32: 1e-5 for y, aux and every gradient (measured at most 1.8e-6).
  At top-1 the renormalised gate is 1 whatever the probabilities, so its
  gradient, 0 in exact arithmetic, is rounding noise in both packages
  (g/s - g·v/s², rounded by each framework's own division rule). With
  expert weights of N(0, 0.3), whose larger outputs make larger gate
  gradients, the router gradient then differs from a float64 evaluation
  by 5e-6 (JAX) and 1e-5 (the port) of its max-abs, and the two by
  1.4e-5; with the weights used here (experts N(0, 0.02), as at init) the
  measured 1.8e-6 above covers it;
- bfloat16 layer: y at 2**-7 (one bf16 step is 2**-8 of the largest
  entries, more of smaller ones; measured 5.4e-3), gradients at 2e-2 (the
  gate's gradient is rounded to bf16 before it reaches the router, and
  the frameworks round activations at different places; measured 1.1e-2);
- the model: the dense GPT-2 tests' tolerances (test_torch_gpt2.py,
  test_torch_train_step.py), with routing decisions that differ between
  the packages in bf16 counted and kept out (MAX_DIFFERING_SHARE).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import mesh as mesh_lib
from ray_tpu.train import train_step as jtrain
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.train import train_step as ttrain
from ray_tpu_torch.train.batch_predictor import TorchPredictor
from ray_tpu_torch.train.checkpoint import Checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]
F32_REL = 1e-5
BF16_Y_REL = 2 ** -7
BF16_GRAD_REL = 2e-2
IMPL_PAIRS = [("auto", "pallas"), ("xla", "xla")]
PORT_FNS = [tmoe.moe_mlp, tmoe.moe_mlp_plain]
PARAM_NAMES = ("router_w", "fc_w", "fc_b", "out_w", "out_b")


def rel(out, ref) -> float:
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def layer_params(seed, D, F, E, zero_router=False):
    """One layer's expert parameters at the init's scales, with nonzero
    biases (so that the bias adds and the empty slots' outputs count)."""
    rng = np.random.default_rng(seed)

    def normal(shape, s):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    p = {"router_w": normal((D, E), 0.3), "fc_w": normal((E, D, F), 0.02),
         "fc_b": normal((E, F), 0.02), "out_w": normal((E, F, D), 0.02),
         "out_b": normal((E, D), 0.02)}
    if zero_router:     # uniform probabilities: every choice is a tie
        p["router_w"][:] = 0
    return p


def torch_tree(tree, dtype=None):
    return {k: torch.tensor(v, dtype=dtype, requires_grad=True)
            for k, v in tree.items()}


def jax_layer(x, p, dy, aux_coeff, **kw):
    """y, aux and the gradients of sum(y·dy) + aux_coeff·aux with respect
    to x and every parameter, from ray_tpu.ops.moe."""
    def f(x, p):
        y, aux = jmoe.moe_mlp(x, p, **kw)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux_coeff * aux, (y, aux)

    (_, (y, aux)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, jax.tree.map(jnp.asarray, p))
    return (np.asarray(y.astype(jnp.float32)), float(aux),
            np.asarray(gx.astype(jnp.float32)), jax.tree.map(np.asarray, gp))


def port_layer(fn, x, p, dy, aux_coeff, **kw):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    y, aux = fn(x, p, **kw)
    ((y.float() * torch.from_numpy(dy)).sum() + aux_coeff * aux).backward()
    return y, aux, x.grad, {k: v.grad for k, v in p.items()}


# --------------------------------------------------------------------------- #
# tests/test_moe.py:14-83 on the port
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fn", PORT_FNS, ids=lambda f: f.__name__)
def test_moe_top1_matches_dense_expert_reference(fn):
    """top_k=1 with room for every token: each token's output is its
    routed expert's MLP applied to it (numpy reference)."""
    B, S, D, F, E = 2, 8, 16, 32, 4
    params = {k: v[0] for k, v in tmoe.moe_init(
        torch.Generator().manual_seed(0), 1, D, F, E, device="cpu").items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, D)).astype(np.float32))
    y, aux = fn(x, params, top_k=1, capacity_factor=float(E),
                dtype=torch.float32)
    assert float(aux) > 0

    xt = x.numpy().reshape(-1, D)
    p = {k: v.numpy() for k, v in params.items()}
    choice = (xt @ p["router_w"]).argmax(-1)
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        e = choice[t]
        h = xt[t] @ p["fc_w"][e] + p["fc_b"][e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h**3)))
        ref[t] = h @ p["out_w"][e] + p["out_b"][e]
    np.testing.assert_allclose(y.numpy().reshape(-1, D), ref, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("fn", PORT_FNS, ids=lambda f: f.__name__)
def test_moe_capacity_drops_overflow_tokens(fn):
    B, S, D, F, E = 1, 8, 8, 16, 2
    params = {k: v[0] for k, v in tmoe.moe_init(
        torch.Generator().manual_seed(0), 1, D, F, E, device="cpu").items()}
    # every token to expert 0: positive inputs, an all-positive expert-0
    # router column (logit_0 = 10·sum(x) > 0 = logit_1)
    params["router_w"] = torch.zeros(D, 2)
    params["router_w"][:, 0] = 10.0
    x = torch.from_numpy(np.abs(np.random.default_rng(1).standard_normal(
        (B, S, D))).astype(np.float32) + 0.1)
    y, _ = fn(x, params, top_k=1, capacity_factor=0.5, dtype=torch.float32)
    # capacity = ceil(8/2·0.5) = 2 slots on expert 0: later tokens dropped
    nonzero = (y[0].abs() > 1e-8).any(-1)
    assert nonzero[:2].all() and not nonzero[2:].any()


def test_moe_gpt2_trains_and_grads_flow():
    cfg = tgpt2.gpt2_tiny(moe_experts=4, moe_top_k=2)
    params = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "moe" in params["blocks"]
    leaves = ttrain.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    tok, tgt = (torch.from_numpy(rng.integers(0, 512, (2, 128))) for _ in range(2))
    loss = tgpt2.loss_fn(params, tok, tgt, cfg)
    loss.backward()
    assert torch.isfinite(loss)
    moe = params["blocks"]["moe"]
    assert float(moe["fc_w"].grad.abs().sum()) > 0, "expert grads must flow"
    assert float(moe["router_w"].grad.abs().sum()) > 0, "router grads must flow"


# --------------------------------------------------------------------------- #
# The layer against ray_tpu.ops.moe
# --------------------------------------------------------------------------- #

LAYER_CASES = {   # id: (top_k, capacity_factor, zero_router)
    "top1-no-drop": (1, 4.0, False),
    "top2-no-drop": (2, 4.0, False),
    "top1-drops": (1, 0.5, False),
    "top2-drops": (2, 0.5, False),
    "top2-1.25": (2, 1.25, False),
    "top2-ties": (2, 0.5, True),
    "top1-ties": (1, 1.25, True),
}


@pytest.mark.parametrize("fn", PORT_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_matches_jax_f32(fn, case):
    top_k, cf, zero_router = LAYER_CASES[case]
    B, S, D, F, E = 2, 32, 16, 32, 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    p = layer_params(3, D, F, E, zero_router)
    kw = dict(top_k=top_k, capacity_factor=cf)
    jy, jaux, jgx, jgp = jax_layer(jnp.asarray(x), p, dy, 0.5,
                                   dtype=jnp.float32, **kw)
    y, aux, gx, gp = port_layer(fn, torch.from_numpy(x), torch_tree(p), dy,
                                0.5, dtype=torch.float32, **kw)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    assert rel(y.detach(), jy) <= F32_REL
    assert abs(float(aux) - jaux) <= F32_REL * abs(jaux)
    assert rel(gx, jgx) <= F32_REL
    for name in PARAM_NAMES:
        assert rel(gp[name], jgp[name]) <= F32_REL, name


@pytest.mark.parametrize("fn", PORT_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_layer_matches_jax_bf16(fn, cf):
    """x in bf16 (the LayerNorm output on the model's path), bf16 compute
    over f32 parameters."""
    B, S, D, F, E = 2, 32, 16, 32, 4
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    x = x.bfloat16()
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    p = layer_params(5, D, F, E)
    kw = dict(top_k=2, capacity_factor=cf)
    jy, jaux, jgx, jgp = jax_layer(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), p, dy, 0.5,
        dtype=jnp.bfloat16, **kw)
    y, aux, gx, gp = port_layer(fn, x, torch_tree(p), dy, 0.5,
                                dtype=torch.bfloat16, **kw)
    assert y.dtype == torch.bfloat16 and gx.dtype == torch.bfloat16
    assert rel(y.detach().float(), jy) <= BF16_Y_REL
    assert abs(float(aux) - jaux) <= F32_REL * abs(jaux)
    assert rel(gx.float(), jgx) <= BF16_GRAD_REL
    for name in PARAM_NAMES:
        assert rel(gp[name], jgp[name]) <= BF16_GRAD_REL, name


def test_ties_go_to_the_lower_index_and_first_choices_come_first():
    """Zero router weights: every probability is 1/E, so every token picks
    experts 0 and 1 (lax.top_k's order). k-major priority: the first
    choices fill expert 0's queue in token order, the second choices
    expert 1's; past C they are dropped."""
    T, D, E, C = 12, 8, 4, 5
    xt = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (T, D)).astype(np.float32))
    for r in (tmoe.route(xt, torch.zeros(D, E), 2, C),
              tmoe.route_plain(xt, torch.zeros(D, E), 2, C)[0]):
        assert r.expert.tolist() == [[0, 1]] * T
        assert r.pos.tolist() == [[t, t] for t in range(T)]
        assert r.keep.tolist() == [[t < C, t < C] for t in range(T)]
        torch.testing.assert_close(r.gate, torch.full((T, 2), 0.5))


def test_routing_matches_the_reference_routing():
    """route (integer counts) against route_plain (the reference's f32
    cumsum over one-hot choices) and against a numpy loop, decision for
    decision, with drops in both queues' orders."""
    T, D, E, k = 64, 8, 4, 2
    rng = np.random.default_rng(7)
    xt = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((D, E)).astype(np.float32))
    C = tmoe.moe_capacity(T, E, k, 0.5)
    r = tmoe.route(xt, w, k, C)
    p = tmoe.route_plain(xt, w, k, C)[0]
    for name in ("expert", "pos", "keep"):
        assert torch.equal(getattr(r, name), getattr(p, name)), name
    torch.testing.assert_close(r.gate, p.gate, atol=0, rtol=0)
    filled = np.zeros(E, int)
    for j in range(k):           # k-major: all first choices, then seconds
        for t in range(T):
            e = int(r.expert[t, j])
            assert int(r.pos[t, j]) == filled[e]
            filled[e] += 1
    assert not r.keep.all() and r.keep.any()


def test_gates_are_renormalised_before_the_drop():
    """Tokens 0, 1 prefer expert 0 and tokens 2, 3 expert 1. With C 2 every
    first choice is kept and every second dropped: y = g1 · expert1(x),
    not expert1(x). With C 1 tokens 1 and 3 lose both choices: y = 0."""
    D, F, E = 4, 8, 2
    p = {k: torch.from_numpy(v) for k, v in layer_params(8, D, F, E).items()}
    p["router_w"] = torch.zeros(D, E)
    p["router_w"][0] = torch.tensor([1.0, -1.0])
    x = torch.zeros(1, 4, D)
    x[0, :, 0] = torch.tensor([1.0, 2.0, -1.0, -2.0])
    probs = torch.softmax(x[0] @ p["router_w"], -1)
    first = probs.argmax(-1)
    g1 = probs.max(-1).values      # renormalised over both choices: sum is 1

    def expert(e, v):
        h = torch.nn.functional.gelu(v @ p["fc_w"][e] + p["fc_b"][e],
                                     approximate="tanh")
        return h @ p["out_w"][e] + p["out_b"][e]

    for fn in PORT_FNS:
        y, _ = fn(x, p, top_k=2, capacity_factor=0.5, dtype=torch.float32)
        for t in range(4):
            want = g1[t] * expert(int(first[t]), x[0, t])
            torch.testing.assert_close(y[0, t], want, atol=1e-6, rtol=1e-6)
        y, _ = fn(x, p, top_k=2, capacity_factor=0.25, dtype=torch.float32)
        assert (y[0, 1] == 0).all() and (y[0, 3] == 0).all()
        assert (y[0, 0] != 0).any() and (y[0, 2] != 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_is_bitwise_repeatable(dtype):
    B, S, D, F, E = 2, 32, 16, 32, 4
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    x = x.to(dtype)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    p = torch_tree(layer_params(10, D, F, E))
    runs = [port_layer(tmoe.moe_mlp, x, p, dy, 0.5, top_k=2,
                       capacity_factor=0.5, dtype=dtype) for _ in range(2)]
    (y0, a0, gx0, gp0), (y1, a1, gx1, gp1) = runs
    assert torch.equal(y0, y1) and torch.equal(a0, a1) and torch.equal(gx0, gx1)
    for name in PARAM_NAMES:
        assert torch.equal(gp0[name], gp1[name]), name


def test_moe_init_shapes_distribution_and_device():
    g = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(g, 3, 32, 64, 4, resid_std=0.005, device="cpu")
    want = {"router_w": (3, 32, 4), "fc_w": (3, 4, 32, 64), "fc_b": (3, 4, 64),
            "out_w": (3, 4, 64, 32), "out_b": (3, 4, 32)}
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in p.values())
    assert abs(float(p["fc_w"].std()) - 0.02) < 1e-3
    assert abs(float(p["out_w"].std()) - 0.005) < 3e-4
    assert torch.all(p["fc_b"] == 0) and torch.all(p["out_b"] == 0)
    jshapes = jax.eval_shape(lambda: jmoe.moe_init(
        jax.random.PRNGKey(0), 3, 32, 64, 4))
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == want
    assert tmoe.moe_capacity(8192, 8, 2, 1.25) == jmoe.moe_capacity(8192, 8, 2, 1.25) == 2560


# --------------------------------------------------------------------------- #
# GPT-2 with MoE blocks against ray_tpu.models.gpt2
# --------------------------------------------------------------------------- #

MOE = dict(moe_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jgpt2.gpt2_tiny(**MOE)
    return jax.tree.map(np.asarray, jgpt2.init(cfg, jax.random.PRNGKey(0)))


def tokens(seed, B=2, S=128, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def pairs(ref, out, prefix=""):
    """(name, reference leaf, port leaf) over a parameter tree, by key."""
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from pairs(v, out[k], prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v, np.float32), out[k]


def port_params(jax_params):
    params = tgpt2.params_from_jax(jax_params, device="cpu")
    for p in ttrain.param_leaves(params):
        p.requires_grad_(True)
    return params


def record_router_inputs(monkeypatch):
    """Patch both packages' MoE layer so that each call records its router
    input (the LayerNorm output, f32 numpy) and router weights, in layer
    order. Returns the two lists (JAX's, the port's)."""
    jrec, trec = [], []
    jax_moe_mlp, port_moe_mlp = jmoe.moe_mlp, tgpt2.moe_mlp

    def jax_recording(x, p, **kw):
        jax.debug.callback(
            lambda v, w: jrec.append((np.asarray(v), np.asarray(w))),
            x.astype(jnp.float32), p["router_w"])
        return jax_moe_mlp(x, p, **kw)

    def port_recording(x, p, **kw):
        trec.append((x.detach().float().numpy(), p["router_w"].detach().numpy()))
        return port_moe_mlp(x, p, **kw)

    monkeypatch.setattr(jmoe, "moe_mlp", jax_recording)
    monkeypatch.setattr(tgpt2, "moe_mlp", port_recording)
    return jrec, trec


def routing_differences(jrec, trec, cfg):
    """Each package's routing decisions, by `route` from its own recorded
    router inputs: the number of (token, choice, layer) decisions whose
    expert or drop differs, of how many, and the first position in each
    batch row from which a token's routing differs in some layer (S where
    none does)."""
    jax.effects_barrier()
    assert len(jrec) == len(trec) == cfg.n_layer
    differ, total, first = 0, 0, None
    for (jx, w), (tx, _) in zip(jrec, trec):
        B, S, D = jx.shape
        C = tmoe.moe_capacity(B * S, cfg.moe_experts, cfg.moe_top_k,
                              cfg.moe_capacity_factor)
        rj, rt = (tmoe.route(torch.from_numpy(x.reshape(B * S, D).copy()),
                             torch.from_numpy(w.copy()), cfg.moe_top_k, C)
                  for x in (jx, tx))
        d = (rj.expert != rt.expert) | (rj.keep != rt.keep)
        differ, total = differ + int(d.sum()), total + d.numel()
        rows = torch.where(d.any(-1).view(B, S), torch.arange(S), S).amin(-1)
        first = rows if first is None else torch.minimum(first, rows)
    jrec.clear()
    trec.clear()
    return differ, total, first


# bf16: the frameworks round LayerNorm and attention outputs at different
# places, so the router's probabilities differ by about 1e-5 and a choice
# whose two candidates lie closer than that can go the other way (measured:
# 1 of 1,024 decisions, layer 1, where JAX's two probabilities were 1e-4
# apart and the router inputs one bf16 step apart). A token routed
# otherwise moves its own output by O(1) and, through attention, the later
# positions of its row; those are left out of the comparison, and the
# differing decisions are held under 1 % (a defect moves most of them).
# f32 must route identically.
MAX_DIFFERING_SHARE = {"float32": 0.0, "bfloat16": 0.01}


@pytest.mark.parametrize("torch_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("dtype_name,tol", [
    ("float32", dict(atol=1e-4, rtol=1e-4)),
    ("bfloat16", dict(atol=3e-2, rtol=0)),
], ids=["f32", "bf16"])
def test_gpt2_moe_logits_match_jax(jax_params, monkeypatch, dtype_name, tol,
                                   torch_impl, jax_impl):
    jcfg = jgpt2.gpt2_tiny(dtype=getattr(jnp, dtype_name),
                           attention_impl=jax_impl, **MOE)
    tcfg = tgpt2.gpt2_tiny(dtype=getattr(torch, dtype_name),
                           attention_impl=torch_impl, **MOE)
    records = record_router_inputs(monkeypatch)
    toks = tokens(0)
    ref = np.asarray(jgpt2.forward(jax_params, jnp.asarray(toks), jcfg)
                     .astype(jnp.float32))
    out = tgpt2.forward(tgpt2.params_from_jax(jax_params, device="cpu"),
                        torch.from_numpy(toks), tcfg)
    assert out.shape == (2, 128, 512)
    differ, total, first = routing_differences(*records, tcfg)
    assert differ <= MAX_DIFFERING_SHARE[dtype_name] * total, (differ, total)
    for b, s in enumerate(first.tolist()):
        np.testing.assert_allclose(out[b, :s].float().numpy(), ref[b, :s], **tol)


@pytest.mark.parametrize("torch_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("chunk", [0, 32])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_gpt2_moe_loss_and_grads_match_jax(jax_params, monkeypatch, dtype_name,
                                           chunk, torch_impl, jax_impl):
    """The loss includes moe_aux_coeff · aux on both the fused and the
    chunked cross-entropy branch. Where a token's routing differs (bf16,
    see MAX_DIFFERING_SHARE), the targets of its row from it on are set
    to -1 (ignored) in both packages, so that the loss and the gradients
    come from positions that no differing decision reaches (attention is
    causal)."""
    kw = dict(loss_chunk=chunk, **MOE)
    jcfg = jgpt2.gpt2_tiny(dtype=getattr(jnp, dtype_name),
                           attention_impl=jax_impl, **kw)
    tcfg = tgpt2.gpt2_tiny(dtype=getattr(torch, dtype_name),
                           attention_impl=torch_impl, **kw)
    records = record_router_inputs(monkeypatch)
    jax_loss_and_grads = jax.jit(jax.value_and_grad(jgpt2.loss_fn),
                                 static_argnums=3)
    batch = jtrain.synthetic_batch(jcfg, 2, seed=0)
    targets = batch["targets"].copy()
    for attempt in range(2):
        jloss, jgrads = jax_loss_and_grads(jax_params, batch["tokens"], targets,
                                           jcfg)
        params = port_params(jax_params)
        loss = tgpt2.loss_fn(params, batch["tokens"], targets, tcfg)
        loss.backward()
        differ, total, first = routing_differences(*records, tcfg)
        assert differ <= MAX_DIFFERING_SHARE[dtype_name] * total, (differ, total)
        if attempt or (first == targets.shape[1]).all():
            break
        for b, s in enumerate(first.tolist()):
            targets[b, s:] = -1
    assert (targets >= 0).mean() > 0.5
    _, jaux = jax.jit(jgpt2._trunk, static_argnums=2)(
        jax_params, jnp.asarray(batch["tokens"]), jcfg)
    with torch.no_grad():
        _, aux = tgpt2._trunk(params, batch["tokens"], tcfg)
    # bf16: aux moves with the router's probabilities and with any top-1
    # choice that goes the other way (1/T of frac_tokens each; measured
    # 1.0e-4 relative)
    loss_tol, grad_rel, aux_rel = ((1e-5, 1e-5, F32_REL) if dtype_name == "float32"
                                   else (1e-3, 3e-2, 1e-3))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= aux_rel * float(jaux)
    assert abs(float(loss.detach()) - float(jloss)) <= loss_tol
    for name, ref, out in pairs(jax.device_get(jgrads), params):
        assert rel(out.grad, ref) <= grad_rel, name


def test_gpt2_moe_three_train_steps_match_jax():
    """3 steps of make_gpt2_train_step on gpt2_tiny with MoE (f32) against
    JAX's under single_device_mesh, from the same params: loss, grad_norm
    and every param (router included: the decay applies to all) after the
    last step."""
    jcfg = jgpt2.gpt2_tiny(dtype=jnp.float32, attention_impl="pallas", **MOE)
    tcfg = tgpt2.gpt2_tiny(dtype=torch.float32, attention_impl="auto", **MOE)
    jb = jtrain.make_gpt2_train_step(
        jcfg, mesh=mesh_lib.single_device_mesh(),
        optimizer=jtrain.default_optimizer(warmup=2, total_steps=10),
        rng=jax.random.PRNGKey(0))
    tb = ttrain.make_gpt2_train_step(
        tcfg, optimizer=ttrain.default_optimizer(warmup=2, total_steps=10),
        device="cpu")
    start = jax.device_get(jb.state["params"])
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
    moved = tstate["params"]["blocks"]["moe"]["router_w"]
    assert not torch.equal(moved, torch.from_numpy(
        np.asarray(start["blocks"]["moe"]["router_w"])))
    for name, ref, out in pairs(jax.device_get(jstate["params"]), tstate["params"]):
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("make,experts", [("gpt2_tiny", 4), ("gpt2_124m", 8)])
def test_param_count_and_flops_match_jax(make, experts):
    tcfg = getattr(tgpt2, make)(moe_experts=experts)
    jcfg = getattr(jgpt2, make)(moe_experts=experts)
    assert tgpt2.param_count(tcfg) == jgpt2.param_count(jcfg)
    assert tgpt2.flops_per_token(tcfg) == jgpt2.flops_per_token(jcfg)
    if make == "gpt2_124m":
        assert tgpt2.param_count(tcfg) == 521_233_920


def test_init_builds_the_moe_subtree_in_the_jax_layout(jax_params):
    cfg = tgpt2.gpt2_tiny(**MOE)
    p = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["blocks"].keys() == jax_params["blocks"].keys()
    for name, ref, out in pairs(jax_params, p):
        assert tuple(out.shape) == ref.shape and out.dtype == torch.float32, name
    assert sum(v.numel() for v in ttrain.param_leaves(p)) == tgpt2.param_count(cfg)
    # out_w at the residual scale 0.02/sqrt(2L), as the JAX init
    assert abs(float(p["blocks"]["moe"]["out_w"].std()) - 0.01) < 5e-4
    names = [n for n, _ in ttrain.named_leaves(p)]
    assert "blocks.moe.router_w" in names and "blocks.fc_w" not in names


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_same_gradients(remat):
    batch = ttrain.synthetic_batch(tgpt2.gpt2_tiny(), 2, seed=3)
    grads = []
    for r in (False, remat):
        cfg = tgpt2.gpt2_tiny(remat=r, **MOE)
        params = tgpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = ttrain.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tgpt2.loss_fn(params, batch["tokens"], batch["targets"], cfg).backward()
        grads.append([p.grad for p in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_module_matches_functional_forward(jax_params):
    cfg = tgpt2.gpt2_tiny(**MOE)
    params = tgpt2.params_from_jax(jax_params, device="cpu")
    module = tgpt2.GPT2(cfg, params)
    names = {n for n, _ in module.named_parameters()}
    assert "blocks.moe.fc_w" in names and len(names) == len(
        list(ttrain.named_leaves(params)))
    toks = torch.from_numpy(tokens(1, S=64))
    with torch.inference_mode():
        torch.testing.assert_close(module(toks), tgpt2.forward(params, toks, cfg),
                                   atol=0, rtol=0)


def test_checkpoint_directory_and_predictor_on_the_nested_tree(tmp_path):
    cfg = tgpt2.gpt2_tiny(dtype=torch.float32, **MOE)
    params = tgpt2.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    path = Checkpoint.from_dict({"params": params}).to_directory(str(tmp_path))
    back = Checkpoint.from_directory(path).to_dict()["params"]
    assert back["blocks"].keys() == params["blocks"].keys()
    for (name, a), (_, b) in zip(ttrain.named_leaves(params),
                                 ttrain.named_leaves(back)):
        assert torch.equal(a, b), name

    def apply_fn(p, batch):
        return tgpt2.forward(p, batch["tokens"], cfg)[:, -1].argmax(-1)

    pred = TorchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                          apply_fn=apply_fn, device="cpu")
    toks = ttrain.synthetic_batch(cfg, 2, seed=5)["tokens"][:, :32]
    got = pred.predict({"tokens": toks})["predictions"]
    want = tgpt2.forward(params, torch.from_numpy(toks), cfg)[:, -1].argmax(-1)
    np.testing.assert_array_equal(got, want.numpy())


def test_the_model_path_never_reaches_the_plain_layer(monkeypatch):
    """moe_mlp_plain and route_plain are for the tests and chip_smoke.py:
    the models and the train step neither name them nor reach them."""
    for sub in ("models", "train"):
        for f in (REPO / "ray_tpu_torch" / sub).rglob("*.py"):
            text = f.read_text()
            assert "moe_mlp_plain" not in text and "route_plain" not in text, f

    def refuse(*args, **kwargs):
        raise AssertionError("the model path reached the plain MoE layer")

    monkeypatch.setattr(tmoe, "moe_mlp_plain", refuse)
    monkeypatch.setattr(tmoe, "route_plain", refuse)
    cfg = tgpt2.gpt2_tiny(n_layer=1, **MOE)
    bundle = ttrain.make_gpt2_train_step(cfg, device="cpu")
    _, m = bundle.step_fn(bundle.state, ttrain.synthetic_batch(cfg, 2))
    assert torch.isfinite(m["loss"])
    with torch.inference_mode():
        tgpt2.forward(bundle.state["params"], torch.zeros(1, 8, dtype=torch.long),
                      cfg)

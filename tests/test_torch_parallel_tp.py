"""Port vs JAX: tensor parallelism (the mesh's tp axis) in the meshed train
step and the meshed forward, in 4 processes over gloo, against the JAX
package's step on the same MeshSpec over 4 of the 8 virtual CPU devices.

The plans run in two spawns of tests/torch_parallel_ranks.py, as
tests/test_torch_parallel_train.py runs its own (whose helpers these
are), with its tolerances: loss atol 1e-5, grad norm rtol 1e-4, params
after two steps atol 1e-5 (f32), every rank bitwise the same, each local
shard the JAX shard's shape; three plans start from nonzero biases, so
that a bias counted on every tp rank shows. Two plans checkpoint their
blocks: a GPT-2 one under remat "dots", which keeps the products the
row-parallel sums sum, and a Llama one under remat True. The reference's own tp tests are
tests/test_gpt2_model.py:84-102, tests/test_llama_model.py:51-66 and
:102-120, tests/test_moe.py:84-110 and tests/test_pipeline.py:109-119.

Beside the train plans: the Llama fsdp2·tp2 forward's logits, gathered
over tp, against ray_tpu.models.llama.forward on one device at rtol/atol
2e-4 (as test_llama_model.py:51 holds its own), and vocab_parallel_xent
over tp 4 against softmax_xent on the full logits.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.ops.cross_entropy import softmax_xent
from test_torch_parallel_train import (
    GPT2, batches, check_plan, flat, jax_cfg, jax_reference, run_ranks,
)

LLAMA = {"model": "llama", "kind": "train", "cfg": {"dtype": "float32"}}
GPT2_PLANS = [
    {**GPT2, "name": "gpt2_dp2tp2", "mesh": {"dp": 2, "tp": 2},
     "random_biases": True},
    {**GPT2, "name": "gpt2_fsdp2tp2_unequal", "mesh": {"fsdp": 2, "tp": 2},
     "unequal": True},
    {**GPT2, "name": "gpt2_tp4", "mesh": {"tp": 4}},
    {**GPT2, "name": "gpt2_dp2tp2_chunked", "mesh": {"dp": 2, "tp": 2},
     "cfg": {"dtype": "float32", "loss_chunk": 32}},
    # the checkpoint keeps the products that the row-parallel sums sum
    {**GPT2, "name": "gpt2_dp2tp2_remat_dots", "mesh": {"dp": 2, "tp": 2},
     "cfg": {"dtype": "float32", "remat": "dots"}, "random_biases": True},
]
XENT = {"kind": "xent", "name": "xent_tp4", "tp": 4}
OTHER_PLANS = [
    {**LLAMA, "name": "llama_dp2tp2", "mesh": {"dp": 2, "tp": 2}},
    {**LLAMA, "name": "llama_fsdp2tp2", "mesh": {"fsdp": 2, "tp": 2}},
    {**LLAMA, "name": "llama_dp2tp2_remat", "mesh": {"dp": 2, "tp": 2},
     "cfg": {"dtype": "float32", "remat": True}},
    # capacity factor 1.0: 512 slots an expert for the 2,048 choices of the
    # 1,024 tokens every rank holds (dp 1), so drops happen
    {"model": "gpt2", "kind": "train", "name": "moe_ep2tp2",
     "cfg": {"dtype": "float32", "moe_experts": 4, "moe_top_k": 2,
             "moe_capacity_factor": 1.0},
     "mesh": {"ep": 2, "tp": 2}, "random_biases": True},
    {**GPT2, "name": "gpt2_pp2tp2", "mesh": {"pp": 2, "tp": 2},
     "cfg": {"dtype": "float32", "pipeline_microbatches": 4}},
]
FORWARD = {"model": "llama", "kind": "forward", "name": "llama_forward_fsdp2tp2",
           "cfg": {"dtype": "float32"}, "mesh": {"fsdp": 2, "tp": 2}}


def forward_reference(plan, workdir):
    """tests/test_llama_model.py:51's inputs: llama_tiny params from
    PRNGKey(2), tokens arange(64) mod V; its one-device logits."""
    cfg = jax_cfg(plan)
    params = jax.device_get(jllama.init(cfg, jax.random.PRNGKey(2)))
    toks = np.arange(64, dtype=np.int32)[None, :] % cfg.vocab_size
    np.savez(workdir / f"{plan['name']}.npz", tokens=toks,
             **{"init/" + n: np.asarray(v, np.float32) for n, v in flat(params)})
    return np.asarray(jllama.forward(params, toks, cfg))


def xent_inputs(plan, workdir):
    """Logits [2, 16, 64] (16 vocabulary entries a rank at tp 4), targets
    with ignored positions and every shard's first and last entry, and a
    gradient for each position's nll."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((2, 16, 64)) * 3).astype(np.float32)
    targets = rng.integers(0, 64, (2, 16)).astype(np.int64)
    targets[0, :8] = [0, 15, 16, 31, 32, 47, 48, 63]
    targets[1, :3] = -1
    g = rng.uniform(0.5, 1.5, (2, 16)).astype(np.float32)
    np.savez(workdir / f"{plan['name']}.npz", logits=logits, targets=targets, g=g)
    return logits, targets, g


def spawn(tmp_path_factory, plans):
    workdir = tmp_path_factory.mktemp("ranks")
    devices = jax.devices("cpu")
    refs = {}
    for p in plans:
        if p["kind"] == "train":
            refs[p["name"]] = jax_reference(p, workdir, devices)
        elif p["kind"] == "forward":
            refs[p["name"]] = forward_reference(p, workdir)
        else:
            refs[p["name"]] = xent_inputs(p, workdir)
    refs["workdir"] = workdir
    return refs, run_ranks(workdir, plans)


@pytest.fixture(scope="module")
def gpt2_runs(tmp_path_factory):
    return spawn(tmp_path_factory, GPT2_PLANS + [XENT])


@pytest.fixture(scope="module")
def other_runs(tmp_path_factory):
    return spawn(tmp_path_factory, OTHER_PLANS + [FORWARD])


@pytest.mark.parametrize("name", [p["name"] for p in GPT2_PLANS])
def test_gpt2_tp_plans_match_jax(gpt2_runs, name):
    check_plan(*gpt2_runs, name)


def test_gpt2_tp_leaves_hold_their_tp_share(gpt2_runs):
    """tp4 at gpt2_tiny's H 4: one head, F/4 MLP columns and V/4 vocabulary
    rows a rank; the LayerNorms and the row-parallel biases whole."""
    meta = gpt2_runs[1]["gpt2_tp4"][0][1]["leaves"]
    assert meta["blocks.qkv_w"]["local"] == [2, 128, 3, 1, 32]
    assert meta["blocks.qkv_w"]["placements"][5] == "Shard(dim=3)"
    assert meta["blocks.fc_w"]["local"] == [2, 128, 128]
    assert meta["wte"]["local"] == [128, 128]
    for whole in ("blocks.proj_b", "blocks.out_b", "blocks.ln1_scale", "wpe"):
        assert meta[whole]["local"] == meta[whole]["global"], whole


def test_unequal_targets_in_every_vocab_shard(gpt2_runs):
    """fsdp2·tp2: the two batch ranks count different numbers of targets,
    and each tp rank's vocabulary half holds targets of both."""
    plan = GPT2_PLANS[1]
    targets = batches(jax_cfg(plan), plan)[0]["targets"]
    halves = np.split(targets, 2)
    assert (halves[0] >= 0).sum() != (halves[1] >= 0).sum()
    for rows in halves:
        assert ((rows >= 0) & (rows < 256)).any() and (rows >= 256).any()
    check_plan(*gpt2_runs, plan["name"])


def test_vocab_parallel_xent_matches_softmax_xent(gpt2_runs):
    """Loss and gradient over tp 4 against softmax_xent on the full logits,
    f32 and bf16: the nll the same on every rank, the shards' gradients
    side by side the full gradient, 0 at ignored positions."""
    refs, results = gpt2_runs
    logits, targets, g = refs["xent_tp4"]
    ranks = sorted(results["xent_tp4"], key=lambda r: r[1]["tp_rank"])
    for dtype, tol in (("float32", dict(rtol=1e-6, atol=1e-6)),
                       ("bfloat16", dict(rtol=2 ** -8, atol=1e-6))):
        full = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
        nll = softmax_xent(full, torch.from_numpy(targets))
        (nll * torch.from_numpy(g)).sum().backward()
        for out, _ in ranks:
            np.testing.assert_array_equal(out[f"nll/{dtype}"],
                                          ranks[0][0][f"nll/{dtype}"])
        np.testing.assert_allclose(ranks[0][0][f"nll/{dtype}"],
                                   nll.detach().numpy(), rtol=1e-6, atol=1e-6)
        grad = np.concatenate([out[f"grad/{dtype}/{r}"]
                               for r, (out, _) in enumerate(ranks)], axis=-1)
        np.testing.assert_allclose(grad, full.grad.float().numpy(), **tol)
        assert not grad[1, :3].any()
    assert (ranks[0][0]["nll/float32"][1, :3] == 0).all()


@pytest.mark.parametrize("name", ["llama_dp2tp2", "llama_fsdp2tp2",
                                  "llama_dp2tp2_remat"])
def test_llama_tp_plans_match_jax(other_runs, name):
    meta = check_plan(*other_runs, name)
    # llama_tiny's 4 heads over 2 kv heads: 2 and 1 a rank, the group
    # count 2 unchanged
    assert meta["leaves"]["blocks.wq"]["local"][2] == 2
    assert meta["leaves"]["blocks.wk"]["local"][2] == 1
    assert meta["leaves"]["lm_head"]["local"][1] == 128
    assert meta["leaves"]["blocks.attn_norm"]["local"][1] == (
        32 if "fsdp" in name else 64)


def test_llama_fsdp2_tp2_forward_matches_one_device(other_runs):
    refs, results = other_runs
    ranks = results[FORWARD["name"]]
    for out, meta in ranks:
        assert meta["local"] == [1, 64, 128]
        np.testing.assert_array_equal(out["logits"], ranks[0][0]["logits"])
    np.testing.assert_allclose(ranks[0][0]["logits"], refs[FORWARD["name"]],
                               rtol=2e-4, atol=2e-4)


def test_moe_ep2_tp2_matches_jax_with_drops(other_runs):
    """Experts split over ep, their MLP columns over tp, capacity binding;
    every rank of a tp group routes every token alike."""
    refs, results = other_runs
    meta = check_plan(refs, results, "moe_ep2tp2")
    assert sum(meta["dropped"]) > 0, meta["dropped"]
    fc = meta["leaves"]["blocks.moe.fc_w"]
    assert fc["local"] == [2, 2, 128, 256] and fc["global"] == [2, 4, 128, 512]
    assert meta["leaves"]["blocks.moe.router_w"]["local"] == [2, 128, 4]
    workdir = refs["workdir"]
    routing = [np.load(workdir / f"moe_ep2tp2.{r}.routing.npz") for r in range(4)]
    assert len(routing[0].files) == 2 * 2 * 2     # layers x steps x (expert, keep)
    for a, b in ((0, 1), (2, 3)):                 # the tp groups (tp innermost)
        assert results["moe_ep2tp2"][a][1]["tp_rank"] == 0
        assert results["moe_ep2tp2"][b][1]["tp_rank"] == 1
        for k in routing[a].files:
            np.testing.assert_array_equal(routing[a][k], routing[b][k], err_msg=k)


def test_gpt2_pp2_tp2_matches_jax(other_runs):
    """tests/test_pipeline.py:109 on 4 ranks: GPipe over the pp group (4
    microbatches of 2 rows), each stage's blocks tensor-parallel over its
    tp group."""
    meta = check_plan(*other_runs, "gpt2_pp2tp2")
    qkv = meta["leaves"]["blocks.qkv_w"]
    assert qkv["local"] == [1, 128, 3, 2, 32]
    assert qkv["placements"][1] == "Shard(dim=0)"
    assert qkv["placements"][5] == "Shard(dim=3)"

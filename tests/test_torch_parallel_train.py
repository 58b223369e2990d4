"""Port vs JAX: training over a device mesh (ray_tpu_torch.parallel, the
meshed make_gpt2_train_step / make_llama_train_step) in 4 processes over
gloo, against the JAX package's step on the same MeshSpec over 4 of the
8 virtual CPU devices.

Per group of plans, the JAX references (the initial params, read before the
donating first step, two steps' loss and grad norm, the params after them
and each leaf's shard shape) are computed here and handed to 4 processes
of tests/torch_parallel_ranks.py, which import no JAX. Each rank sets its
params from the same initial tree through shard_tree and takes the same
two global batches. The first step runs at lr 0 (the reference schedule's
warm-up), the second at lr 1.5e-4.

Tolerances, as tests/test_torch_train_step.py's and tests/test_pipeline.py's:
loss atol 1e-5, grad norm rtol 1e-4, the gathered params after the steps
atol 1e-5 (f32 throughout). Loss, grad norm and params must be bitwise the
same on every rank. Each leaf's local shard must have the JAX shard's shape.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import train_step as jtrain

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_parallel_ranks.py"
WORLD = 4
LIMIT_S = 150           # a spawn's wall-clock limit; each rank's gloo
                        # collectives time out at 60 s


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def jax_cfg(plan):
    kw = dict(plan.get("cfg", {}))
    for k in ("dtype", "param_dtype"):
        if k in kw:
            kw[k] = getattr(jnp, kw[k])
    return (jgpt2.gpt2_tiny if plan["model"] == "gpt2" else jllama.llama_tiny)(**kw)


def batches(cfg, plan):
    out = [jtrain.synthetic_batch(cfg, 8, seed=s) for s in (0, 1)]
    if plan.get("unequal"):
        # the ranks of dp2·fsdp2 hold rows 0-1, 2-3, 4-5, 6-7: give them
        # different numbers of ignored targets
        for b in out:
            b["targets"][0:2, :100] = -1
            b["targets"][5, :17] = -1
    return out


def jax_reference(plan, workdir: Path, devices):
    """Run the JAX step of `plan` and write the ranks' inputs; returns the
    reference numbers."""
    cfg = jax_cfg(plan)
    spec = jmesh.MeshSpec(**plan["mesh"])
    mesh = jmesh.make_mesh(spec, devices[:spec.num_devices])
    make = (jtrain.make_gpt2_train_step if plan["model"] == "gpt2"
            else jtrain.make_llama_train_step)
    bundle = make(cfg, mesh=mesh,
                  optimizer=jtrain.default_optimizer(warmup=2, total_steps=10),
                  rng=jax.random.PRNGKey(0))
    params = bundle.state["params"]
    if plan.get("random_biases"):
        # nonzero biases (the init's are 0), so that a bias added on every
        # tp rank before a row-parallel sum, tp times, shows
        rng = np.random.default_rng(3)
        params = jax.tree_util.tree_map_with_path(
            lambda path, p: jax.device_put(
                p + rng.normal(0, 0.02, p.shape).astype(p.dtype), p.sharding)
            if path[-1].key.endswith(("_b", "_bias")) else p, params)
    shard_shapes = {n: list(p.sharding.shard_shape(p.shape))
                    for n, p in flat(params)}
    init = dict(flat(jax.device_get(params)))   # before the donating step
    data = batches(cfg, plan)
    state, losses, norms = {**bundle.state, "params": params}, [], []
    for b in data:
        state, m = bundle.step_fn(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.savez(workdir / f"{plan['name']}.npz",
             tokens=np.stack([b["tokens"] for b in data]),
             targets=np.stack([b["targets"] for b in data]),
             **{"init/" + n: np.asarray(v, np.float32) for n, v in init.items()})
    return {"loss": np.array(losses), "grad_norm": np.array(norms),
            "after": dict(flat(jax.device_get(state["params"]))),
            "shard_shapes": shard_shapes,
            "specs": {n: p.sharding.spec for n, p in flat(params)}}


def run_ranks(workdir: Path, plans):
    """Start WORLD rank processes on `plans`, wait at most LIMIT_S, kill
    what is left; returns each plan's per-rank (npz, json)."""
    (workdir / "plans.json").write_text(json.dumps(plans))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(RANKS), str(workdir),
                               str(r), str(WORLD)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=str(workdir))
             for r in range(WORLD)]
    deadline = time.monotonic() + LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * WORLD:
        tails = "\n".join(f"--- rank {r} (exit {c})\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes))
        pytest.fail(f"rank processes failed or timed out: {codes}\n{tails}")
    return {p["name"]: [(np.load(workdir / f"{p['name']}.{r}.npz"),
                         json.loads((workdir / f"{p['name']}.{r}.json").read_text()))
                        for r in range(WORLD)] for p in plans}


def run_group(tmp_path_factory, devices, plans):
    workdir = tmp_path_factory.mktemp("ranks")
    refs = {p["name"]: jax_reference(p, workdir, devices)
            for p in plans if p["kind"] == "train"}
    return refs, run_ranks(workdir, plans)


def check_plan(refs, results, name):
    ref, ranks = refs[name], results[name]
    first, meta0 = ranks[0]
    for out, meta in ranks[1:]:          # the same on every rank, bitwise
        for k in first.files:
            np.testing.assert_array_equal(out[k], first[k], err_msg=k)
    np.testing.assert_allclose(first["loss"], ref["loss"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(first["grad_norm"], ref["grad_norm"], rtol=1e-4)
    for leaf, want in ref["after"].items():
        np.testing.assert_allclose(first["after/" + leaf], want, atol=1e-5,
                                   rtol=0, err_msg=leaf)
    for _, meta in ranks:
        for leaf, info in meta["leaves"].items():
            assert info["local"] == ref["shard_shapes"][leaf], (leaf, info)
            assert info["moment"] == info["local"], (leaf, info)
            assert info["shard_is_local"], leaf
    return meta0


GPT2 = {"model": "gpt2", "kind": "train", "cfg": {"dtype": "float32"}}
GPT2_PLANS = [
    {**GPT2, "name": "dp4", "mesh": {"dp": 4}},
    {**GPT2, "name": "fsdp4", "mesh": {"fsdp": 4}},
    {**GPT2, "name": "dp2fsdp2", "mesh": {"dp": 2, "fsdp": 2}, "multi_step": True},
    {**GPT2, "name": "dp2fsdp2_unequal", "mesh": {"dp": 2, "fsdp": 2},
     "unequal": True},
]


@pytest.fixture(scope="module")
def gpt2_runs(tmp_path_factory):
    return run_group(tmp_path_factory, jax.devices("cpu"), GPT2_PLANS)


@pytest.mark.parametrize("name", [p["name"] for p in GPT2_PLANS])
def test_gpt2_mesh_plans_match_jax(gpt2_runs, name):
    check_plan(*gpt2_runs, name)


def test_gpt2_fsdp_leaves_are_sharded_by_the_rule_table(gpt2_runs):
    """fsdp4: a leaf with an "embed" dim holds a quarter of it, the others
    are whole; the placement says so."""
    refs, results = gpt2_runs
    meta = results["fsdp4"][0][1]
    assert meta["leaves"]["wte"]["local"] == [512, 32]
    assert meta["leaves"]["wte"]["placements"][2] == "Shard(dim=1)"
    assert meta["leaves"]["blocks.qkv_b"]["local"] == meta["leaves"]["blocks.qkv_b"]["global"]
    assert "fsdp" in str(refs["fsdp4"]["specs"]["wte"])


def test_unequal_target_counts_normalise_over_the_global_batch(gpt2_runs):
    """The ranks hold different numbers of counted targets; the loss is
    Σ nll over all of them / their global count, not a mean of means."""
    refs, results = gpt2_runs
    counts = [(t >= 0).sum() for t in np.split(
        batches(jax_cfg(GPT2_PLANS[3]), GPT2_PLANS[3])[0]["targets"], 4)]
    assert len(set(counts)) > 1
    check_plan(refs, results, "dp2fsdp2_unequal")


def test_multi_step_equals_repeated_step_over_a_mesh(gpt2_runs):
    for _, meta in gpt2_runs[1]["dp2fsdp2"]:
        assert meta["multi_step_equal"]


@pytest.fixture(scope="module")
def llama_runs(tmp_path_factory):
    plans = [{"model": "llama", "kind": "train", "name": "llama_dp2fsdp2",
              "cfg": {"dtype": "float32"}, "mesh": {"dp": 2, "fsdp": 2}}]
    return run_group(tmp_path_factory, jax.devices("cpu"), plans)


def test_llama_dp2_fsdp2_matches_jax(llama_runs):
    meta = check_plan(*llama_runs, "llama_dp2fsdp2")
    assert meta["leaves"]["lm_head"]["local"] == [32, 256]


# capacity factor 1.0: 512 slots an expert for the 2,048 choices of 1,024
# tokens, so an expert over a quarter of the choices drops some
MOE_PLAN = {"model": "gpt2", "kind": "train", "name": "moe_dp2ep2",
            "cfg": {"dtype": "float32", "moe_experts": 4, "moe_top_k": 2,
                    "moe_capacity_factor": 1.0},
            "mesh": {"dp": 2, "ep": 2}}


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    return run_group(tmp_path_factory, jax.devices("cpu"), [MOE_PLAN])


def test_moe_dp2_ep2_matches_jax(moe_runs):
    """Global capacity and queue places over dp, experts split over ep: the
    same step as the reference's, where capacity binds."""
    meta = check_plan(*moe_runs, "moe_dp2ep2")
    assert sum(meta["dropped"]) > 0, meta["dropped"]


def test_moe_expert_leaves_hold_their_ep_share(moe_runs):
    refs, results = moe_runs
    for _, meta in results["moe_dp2ep2"]:
        fc = meta["leaves"]["blocks.moe.fc_w"]
        assert fc["placements"][3] == "Shard(dim=1)"       # ep
        assert fc["local"][1] == 2 and fc["global"][1] == 4
        router = meta["leaves"]["blocks.moe.router_w"]
        assert router["local"] == router["global"]
    assert "ep" in str(refs["moe_dp2ep2"]["specs"]["blocks.moe.fc_w"])


PP_PLAN = {"model": "gpt2", "kind": "train", "name": "dp2pp2",
           "cfg": {"dtype": "float32", "pipeline_microbatches": 4},
           "mesh": {"dp": 2, "pp": 2}}


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    return run_group(tmp_path_factory, jax.devices("cpu"),
                     [PP_PLAN, {"kind": "refusals", "name": "refusals"}])


def test_gpt2_dp2_pp2_matches_jax(pp_runs):
    """GPipe over the pp group (4 microbatches of the 4 rows a dp rank
    holds) against the reference's pipelined step: the layer stack is
    sharded over pp."""
    refs, results = pp_runs
    meta = check_plan(refs, results, "dp2pp2")
    assert meta["leaves"]["blocks.qkv_w"]["placements"][1] == "Shard(dim=0)"
    assert meta["leaves"]["blocks.qkv_w"]["local"][0] == 1
    assert "pp" in str(refs["dp2pp2"]["specs"]["blocks.qkv_w"])


@pytest.mark.parametrize("case,error,match", [
    ("moe_with_pp", "NotImplementedError", "pipeline"),
    ("n_layer_not_divisible", "ValueError", "not divisible"),
    ("batch_not_divisible_by_microbatches", "ValueError", "not divisible"),
    ("tp_not_dividing_kv_heads", "ValueError", "not divisible"),
    ("seq_len_not_divisible_by_cp", "ValueError",
     "sequence length 126 not divisible by cp axis size 4"),
    ("batch_seq_not_divisible_by_cp", "ValueError",
     "sequence length 126 not divisible by cp axis size 4"),
])
def test_mesh_plan_refusals(pp_runs, case, error, match):
    for _, results in pp_runs[1]["refusals"]:
        assert results[case].startswith(error + ":"), results[case]
        assert match in results[case], results[case]


def test_shard_tree_names_the_tp_axis(pp_runs):
    """Placing llama_tiny's 2 kv heads over tp 4: the error names the
    logical axis, the mesh axis and its size."""
    for _, results in pp_runs[1]["refusals"]:
        msg = results["shard_tree_tp_not_dividing"]
        assert msg.startswith("ValueError:"), msg
        assert "('heads')" in msg and "not divisible by tp=4" in msg, msg

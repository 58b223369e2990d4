"""Port vs JAX: the mesh plans of the meshed train step that mix the MoE
layer with cp and the pipeline with cp, in 4 processes over gloo,
against the JAX package's step on the same MeshSpec over 4 of the 8
virtual CPU devices.

- MoE·cp: gpt2_tiny(moe_experts=4, moe_top_k=2) over fsdp2·cp2, ep2·cp2
  and, at capacity factor 0.5, dp2·cp2. A rank holds its chunk of each of
  its rows, so its tokens are not contiguous in the reference's k-major
  (batch, sequence) order; each choice's place in its expert's queue,
  the capacity and the load-balancing loss count every rank's tokens
  over (dp, fsdp, cp). At capacity 0.5 tokens are dropped, so the queue's
  order decides the result.
- pp·cp: gpt2_tiny over pp2·cp2 with 4 microbatches: each stage's block
  runs the ring over its stage's cp group inside the GPipe schedule.

The plans run in one spawn of tests/torch_parallel_ranks.py with the
helpers and tolerances of tests/test_torch_parallel_train.py: loss atol
1e-5, grad norm rtol 1e-4, params after two steps atol 1e-5 (f32), every
rank bitwise the same, each local shard the JAX shard's shape.
"""

import jax
import pytest

from test_torch_parallel_train import check_plan, run_group

MOE = {"model": "gpt2", "kind": "train",
       "cfg": {"dtype": "float32", "moe_experts": 4, "moe_top_k": 2}}
PLANS = [
    {**MOE, "name": "moe_fsdp2cp2", "mesh": {"fsdp": 2, "cp": 2}},
    {**MOE, "name": "moe_ep2cp2", "mesh": {"ep": 2, "cp": 2}},
    {**MOE, "name": "moe_dp2cp2_drops", "mesh": {"dp": 2, "cp": 2},
     "cfg": {**MOE["cfg"], "moe_capacity_factor": 0.5}},
    {"model": "gpt2", "kind": "train", "name": "gpt2_pp2cp2",
     "cfg": {"dtype": "float32", "pipeline_microbatches": 4},
     "mesh": {"pp": 2, "cp": 2}},
]
# gpt2_tiny: 2 layers, 16 parameter leaves (17 with MoE blocks)
LAYERS = 2


@pytest.fixture(scope="module")
def plan_runs(tmp_path_factory):
    return run_group(tmp_path_factory, jax.devices("cpu"), PLANS)


@pytest.mark.parametrize("name", [p["name"] for p in PLANS])
def test_plans_match_jax(plan_runs, name):
    check_plan(*plan_runs, name)


def moe_cp_collectives_per_step(leaves: int) -> int:
    """By hand, a MoE·cp2 step's collectives over cp: in each layer the
    ring's 1 rotation forward and 2 backward, the queue's all-gather of
    counts, the load-balancing loss's two sums (top-1 shares, mean
    probabilities) and the rank script's sum of dropped choices; a
    gradient sum a leaf, the count's and the loss's."""
    return LAYERS * (1 + 2 + 3 + 1) + leaves + 2


@pytest.mark.parametrize("name", ["moe_fsdp2cp2", "moe_ep2cp2", "moe_dp2cp2_drops"])
def test_moe_queue_counts_over_the_cp_axis(plan_runs, name):
    """The queue, the capacity and the loss run their collectives over cp
    as well as the batch axes, in each of the 2 steps; every rank holds
    the router whole over cp."""
    refs, results = plan_runs
    for _, meta in results[name]:
        assert meta["collectives"]["cp"] == 2 * moe_cp_collectives_per_step(
            len(meta["leaves"])), meta["collectives"]
        assert meta["leaves"]["blocks.moe.router_w"]["placements"][4] == "Replicate()"


def test_capacity_half_drops_tokens(plan_runs):
    """At capacity factor 0.5 each layer call drops choices over the
    global batch (the sum over dp and cp, the same on every rank), so a
    wrong queue order would change which ones."""
    _, results = plan_runs
    dropped = [meta["dropped"] for _, meta in results["moe_dp2cp2_drops"]]
    assert all(d == dropped[0] for d in dropped)
    assert len(dropped[0]) == 2 * LAYERS and all(d > 0 for d in dropped[0]), dropped


def test_pipeline_over_cp_shards_the_layers_over_pp(plan_runs):
    """pp2·cp2: each stage holds its one layer; the ring runs inside the
    schedule, (1 + 2) rotations a live (layer, microbatch) pair: 4 pairs
    a stage a step."""
    refs, results = plan_runs
    for _, meta in results["gpt2_pp2cp2"]:
        assert meta["leaves"]["blocks.qkv_w"]["placements"][1] == "Shard(dim=0)"
        assert meta["leaves"]["blocks.qkv_w"]["local"][0] == 1
        assert meta["collectives"]["cp"] == 2 * (4 * 3 + 16 + 2), meta["collectives"]
    assert "pp" in str(refs["gpt2_pp2cp2"]["specs"]["blocks.qkv_w"])

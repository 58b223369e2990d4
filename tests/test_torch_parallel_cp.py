"""Port vs JAX: context parallelism (the mesh's cp axis) in the meshed
train step, in 4 processes over gloo, against the JAX package's step on
the same MeshSpec over 4 of the 8 virtual CPU devices.

Each rank takes its rows of the global batch and its contiguous S/cp
chunk of every sequence; attention runs as a ring over the cp group
(ops/ring_attention.py), GPT-2's position embedding and Llama's RoPE
start at the chunk's global offset, and each gradient, the count of
targets and the loss are summed over cp. The reference's GPT-2 runs its
own ring (ring_attention_sharded, Pallas in interpret mode), its Llama
attends through GSPMD, which gathers k and v (tests/test_ring_attention.py
:117 is the reference's own cp step test).

The plans run in one spawn of tests/torch_parallel_ranks.py with the
helpers and tolerances of tests/test_torch_parallel_train.py: loss atol
1e-5, grad norm rtol 1e-4, params after two steps atol 1e-5 (f32), every
rank bitwise the same, each local shard the JAX shard's shape. GPT-2 over
cp 4, cp2·tp2 (the reference test's cp·tp), cp2·fsdp2 and cp2·tp2 with
remat True and dp2·cp2 with remat "dots" (the checkpointed block's ring
runs again in the backward, with its exchanges); Llama over cp2·tp2 and
cp 4.
"""

import jax
import pytest

from test_torch_parallel_train import check_plan, run_group

GPT2 = {"model": "gpt2", "kind": "train", "cfg": {"dtype": "float32"}}
LLAMA = {"model": "llama", "kind": "train", "cfg": {"dtype": "float32"}}
PLANS = [
    {**GPT2, "name": "gpt2_cp4", "mesh": {"cp": 4}},
    {**GPT2, "name": "gpt2_cp2tp2", "mesh": {"cp": 2, "tp": 2},
     "random_biases": True},
    {**GPT2, "name": "gpt2_cp2fsdp2", "mesh": {"fsdp": 2, "cp": 2}},
    {**GPT2, "name": "gpt2_cp2tp2_remat", "mesh": {"cp": 2, "tp": 2},
     "cfg": {"dtype": "float32", "remat": True}},
    # remat "dots" saves the products; the ring's forward runs again
    {**GPT2, "name": "gpt2_dp2cp2_remat_dots", "mesh": {"dp": 2, "cp": 2},
     "cfg": {"dtype": "float32", "remat": "dots"}},
    {**LLAMA, "name": "llama_cp2tp2", "mesh": {"cp": 2, "tp": 2}},
    {**LLAMA, "name": "llama_cp4", "mesh": {"cp": 4}},
]
# both tiny configs: 2 layers; gpt2_tiny has 16 parameter leaves,
# llama_tiny 12
LEAVES = {"gpt2": 16, "llama": 12}


def cp_collectives_per_step(plan) -> int:
    """By hand: a ring of cp rotates cp − 1 times forward and cp times
    backward in each of the 2 layers (once more forward where remat, True
    or "dots", reruns the block), each leaf's gradient is summed over cp,
    and so are the count of targets and the loss."""
    cp = plan["mesh"]["cp"]
    rotations = (cp - 1) + cp + (cp - 1 if plan["cfg"].get("remat") else 0)
    return 2 * rotations + LEAVES[plan["model"]] + 2


@pytest.fixture(scope="module")
def cp_runs(tmp_path_factory):
    return run_group(tmp_path_factory, jax.devices("cpu"), PLANS)


@pytest.mark.parametrize("name", [p["name"] for p in PLANS])
def test_cp_plans_match_jax(cp_runs, name):
    plan = next(p for p in PLANS if p["name"] == name)
    meta = check_plan(*cp_runs, name)
    # two steps; a rank holds every parameter whole over cp
    assert meta["collectives"]["cp"] == 2 * cp_collectives_per_step(plan)
    for info in meta["leaves"].values():
        assert info["placements"][4] == "Replicate()", info

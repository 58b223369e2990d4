"""Port vs JAX: "pallas" and "xla" attention under a cp mesh, and Llama
over pp, in the meshed train step, in 4 processes over gloo, against the
JAX package's step on the same MeshSpec over 4 of the 8 virtual CPU
devices.

The reference's models resolve "pallas" (its Pallas kernels, in interpret
mode here) and "xla" (the einsum path) on a sequence-sharded mesh through
GSPMD, which gathers k and v over cp. The port's gathered path
(ops/gathered_attention.py) does the same by hand: k and v all-gathered
over the cp group (Llama's at its kv heads, before they are repeated),
this rank's queries at their global offset against the whole sequence,
and dk and dv reduce-scattered back. GPT-2 "pallas" over fsdp2·cp2 and
"xla" over cp4; Llama "xla" over cp2·tp2 and "pallas" over cp4.

Llama over pp: dp2·pp2 and pp2·tp2. The reference's Llama runs no
pipeline (its rule table leaves the layer stack unsharded), so pp is a
replica axis: the loss and each gradient are those of one copy, not pp
times them.

The plans run in one spawn of tests/torch_parallel_ranks.py with the
helpers and tolerances of tests/test_torch_parallel_train.py: loss atol
1e-5, grad norm rtol 1e-4, params after two steps atol 1e-5 (f32), every
rank bitwise the same, each local shard the JAX shard's shape.
"""

import jax
import pytest

from test_torch_parallel_train import check_plan, run_group

GPT2 = {"model": "gpt2", "kind": "train"}
LLAMA = {"model": "llama", "kind": "train"}
PLANS = [
    {**GPT2, "name": "gpt2_pallas_fsdp2cp2", "mesh": {"fsdp": 2, "cp": 2},
     "cfg": {"dtype": "float32", "attention_impl": "pallas"}},
    {**GPT2, "name": "gpt2_xla_cp4", "mesh": {"cp": 4},
     "cfg": {"dtype": "float32", "attention_impl": "xla"}},
    {**LLAMA, "name": "llama_xla_cp2tp2", "mesh": {"cp": 2, "tp": 2},
     "cfg": {"dtype": "float32", "attention_impl": "xla"}},
    {**LLAMA, "name": "llama_pallas_cp4", "mesh": {"cp": 4},
     "cfg": {"dtype": "float32", "attention_impl": "pallas"}},
]
PP_PLANS = [
    {**LLAMA, "name": "llama_dp2pp2", "mesh": {"dp": 2, "pp": 2},
     "cfg": {"dtype": "float32"}},
    {**LLAMA, "name": "llama_pp2tp2", "mesh": {"pp": 2, "tp": 2},
     "cfg": {"dtype": "float32"}},
]
# both tiny configs: 2 layers; gpt2_tiny has 16 parameter leaves,
# llama_tiny 12
LEAVES = {"gpt2": 16, "llama": 12}


def cp_collectives_per_step(plan) -> int:
    """By hand: in each of the 2 layers one all-gather of k and v forward
    and one reduce-scatter of dk and dv backward, whatever cp is; a
    gradient sum a leaf, the count's and the loss's."""
    return 2 * 2 + LEAVES[plan["model"]] + 2


@pytest.fixture(scope="module")
def gathered_runs(tmp_path_factory):
    return run_group(tmp_path_factory, jax.devices("cpu"), PLANS + PP_PLANS)


@pytest.mark.parametrize("name", [p["name"] for p in PLANS])
def test_gathered_plans_match_jax(gathered_runs, name):
    plan = next(p for p in PLANS if p["name"] == name)
    meta = check_plan(*gathered_runs, name)
    # two steps; a rank holds every parameter whole over cp
    assert meta["collectives"]["cp"] == 2 * cp_collectives_per_step(plan)
    for info in meta["leaves"].values():
        assert info["placements"][4] == "Replicate()", info


@pytest.mark.parametrize("name", [p["name"] for p in PP_PLANS])
def test_llama_over_pp_is_a_replica_axis(gathered_runs, name):
    """The reference's loss, grad norm and params, not pp times the loss;
    every pp rank holds every layer, as the reference's rule table places
    them, and the gradients are handed over pp by broadcast, as over tp,
    not summed."""
    refs, results = gathered_runs
    check_plan(refs, results, name)
    for _, meta in results[name]:
        wq = meta["leaves"]["blocks.wq"]
        assert wq["placements"][1] == "Replicate()"
        assert wq["local"][0] == wq["global"][0] == 2
        assert meta["collectives"]["pp"] == 2 * len(meta["leaves"])
    assert "pp" not in str(refs[name]["specs"]["blocks.wq"])

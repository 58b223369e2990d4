"""Port vs reference: Checkpoint.from_torch / to_torch
(ray_tpu_torch/train/checkpoint.py, torch.distributed.checkpoint) against
orbax's from_jax / to_jax (ray_tpu/train/checkpoint.py).

The train loop's tree (the train step's params, ClippedAdamW's state_dict
with bf16 moments, integer-keyed state, param_groups and count, and the
step) must round-trip bitwise; the same numpy tree restores equal values
through both packages; a checkpoint whose structure differs from the
target falls back to an untargeted restore, a corrupt one raises.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from ray_tpu.train import Checkpoint as JaxCheckpoint
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.train_step import (
    default_optimizer, make_gpt2_train_step, named_leaves, synthetic_batch,
)


@functools.lru_cache(maxsize=None)
def trained(steps: int):
    """A read-only trained state, shared by the tests that only read it."""
    return trained_state(steps)


def trained_state(steps=2, seed=0):
    """gpt2_tiny's train state on the CPU after `steps` steps."""
    cfg = gpt2.gpt2_tiny(n_layer=1)
    bundle = make_gpt2_train_step(
        cfg, optimizer=default_optimizer(warmup=1, total_steps=10),
        generator=torch.Generator().manual_seed(seed), device="cpu")
    state = bundle.state
    for i in range(steps):
        state, _ = bundle.step_fn(state, synthetic_batch(cfg, 2, seed=i))
    return state


def tree_of(state):
    return {"params": state["params"],
            "opt_state": state["opt_state"].state_dict(),
            "step": state["step"]}


def assert_states_equal(a, b):
    """Every param, both moments (and their dtype), step and count, bitwise."""
    pa, pb = dict(named_leaves(a["params"])), dict(named_leaves(b["params"]))
    assert pa.keys() == pb.keys()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    oa, ob = a["opt_state"], b["opt_state"]
    for p, q in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
        for k in ("mu", "nu"):
            assert oa.state[p][k].dtype == ob.state[q][k].dtype == torch.bfloat16
            assert torch.equal(oa.state[p][k], ob.state[q][k])
    assert a["step"] == b["step"] and oa.count == ob.count


def test_round_trip_into_a_target_is_bitwise(tmp_path):
    saved = trained(3)
    ckpt = Checkpoint.from_torch(tree_of(saved), path=str(tmp_path))
    assert os.path.isdir(tmp_path / "torch_state")
    fresh = trained_state(steps=0, seed=1)
    leaves = [p for _, p in named_leaves(fresh["params"])]
    tree = ckpt.to_torch(target=tree_of(fresh))
    fresh["opt_state"].load_state_dict(tree["opt_state"])
    fresh["step"] = tree["step"]
    # in place: the target's own tensors hold the values
    assert all(a is b for a, b in zip(leaves, (p for _, p in named_leaves(fresh["params"]))))
    assert_states_equal(fresh, saved)


def test_round_trip_without_a_target_returns_the_saved_tree(tmp_path):
    saved = trained(2)
    tree = tree_of(saved)
    out = Checkpoint.from_torch(tree, path=str(tmp_path)).to_torch()
    assert out["step"] == 2 and out["opt_state"]["count"] == 2
    for n, p in named_leaves(saved["params"]):
        got = out["params"]
        for k in n.split("."):
            got = got[k]
        assert torch.equal(got, p), n
    # DCP keeps no key types: the integer-keyed state comes back by string
    for i, st in tree["opt_state"]["state"].items():
        for k in ("mu", "nu"):
            got = out["opt_state"]["state"][str(i)][k]
            assert got.dtype == torch.bfloat16 and torch.equal(got, st[k])
    assert out["opt_state"]["param_groups"] == tree["opt_state"]["param_groups"]


def test_the_same_numpy_tree_through_both_packages(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"params": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                       "b": rng.standard_normal(16).astype(np.float32),
                       "blocks": {"ln": rng.standard_normal((2, 16)).astype(np.float32)}},
            "step": 7}
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jout = JaxCheckpoint.from_jax(tree, path=str(jdir)).to_jax()
    ttree = {"params": jax.tree.map(torch.from_numpy, tree["params"]), "step": 7}
    target = {"params": jax.tree.map(torch.zeros_like, ttree["params"]), "step": 0}
    tout = Checkpoint.from_torch(ttree, path=str(tdir)).to_torch(target=target)
    assert int(jout["step"]) == tout["step"] == 7
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree["params"]):
        keys = [k.key for k in path]
        j, t = jout["params"], tout["params"]
        for k in keys:
            j, t = j[k], t[k]
        np.testing.assert_array_equal(np.asarray(j), leaf)
        np.testing.assert_array_equal(t.numpy(), leaf)


def test_a_structure_mismatch_restores_untargeted(tmp_path, caplog):
    """The reference's rule: the checkpoint wraps the target under other
    keys, so the targeted restore fails and the saved tree comes back."""
    w = torch.arange(6.0).reshape(2, 3)
    ckpt = Checkpoint.from_torch({"params": {"w": w}, "step": 1}, path=str(tmp_path))
    with caplog.at_level("WARNING"):
        out = ckpt.to_torch(target={"w": torch.zeros(2, 3)})
    assert "targeted checkpoint restore failed" in caplog.text
    assert torch.equal(out["params"]["w"], w) and out["step"] == 1


def test_a_corrupt_checkpoint_raises_and_is_not_restored(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    ckpt = Checkpoint.from_torch({"w": w, "step": 1}, path=str(tmp_path))
    data = [f for f in os.listdir(tmp_path / "torch_state") if f.endswith(".distcp")]
    assert data
    for f in data:
        (tmp_path / "torch_state" / f).write_bytes(b"not a checkpoint")
    target = {"w": torch.zeros(2, 3), "step": 0}
    with pytest.raises(BaseException) as err:     # DCP's CheckpointException
        ckpt.to_torch(target=target)
    assert not isinstance(err.value, (KeyboardInterrupt, SystemExit))
    assert torch.equal(target["w"], torch.zeros(2, 3)) and target["step"] == 0
    with pytest.raises(BaseException):
        ckpt.to_torch()


def test_dict_checkpoints_refuse_tensor_restores_in_both_packages():
    for ckpt, restore in ((JaxCheckpoint.from_dict({"a": 1}), "to_jax"),
                          (Checkpoint.from_dict({"a": 1}), "to_torch")):
        with pytest.raises(ValueError, match="directory checkpoint"):
            getattr(ckpt, restore)()


def test_optimizer_state_dict_keeps_bf16_moments_and_count():
    state = trained(2)
    opt = state["opt_state"]
    sd = opt.state_dict()
    assert sd["count"] == 2 and sorted(sd["state"]) == list(range(len(sd["state"])))
    fresh = trained_state(steps=0, seed=1)["opt_state"]
    fresh.load_state_dict(sd)
    assert fresh.count == 2
    for p, q in zip(fresh.param_groups[0]["params"], opt.param_groups[0]["params"]):
        for k in ("mu", "nu"):
            assert fresh.state[p][k].dtype == torch.bfloat16
            assert torch.equal(fresh.state[p][k], opt.state[q][k])

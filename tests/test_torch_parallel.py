"""Port vs JAX: ray_tpu_torch.parallel in one process (mesh.py, sharding.py,
pipeline.py without a group, the models' logical axes), and the meshed
train step on a one-rank gloo group: it runs the mesh code (its
collectives, on groups of one, and DTensor placements) and computes the
plain step.

The multi-process runs (dp, fsdp, ep, pp over 4 ranks) are in
tests/test_torch_parallel_train.py, those over tp in
tests/test_torch_parallel_tp.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpipeline
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.train import train_step as ttrain


def outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


def test_mesh_spec_matches_jax():
    for sizes in itertools.product((1, 2), repeat=6):
        kw = dict(zip(tmesh.AXIS_ORDER, sizes))
        t, j = tmesh.MeshSpec(**kw), jmesh.MeshSpec(**kw)
        assert (t.sizes, t.num_devices, t.batch_size_divisor()) == (
            j.sizes, j.num_devices, j.batch_size_divisor())
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    for n, tp, pp, cp, ep, fsdp in itertools.product(
            (1, 4, 6, 8), (1, 2), (1, 2), (1, 3), (1, 2), (None, 1, 2, 3)):
        kw = dict(tp=tp, pp=pp, cp=cp, ep=ep, fsdp=fsdp)
        t = outcome(tmesh.MeshSpec.for_devices, n, **kw)
        j = outcome(jmesh.MeshSpec.for_devices, n, **kw)
        assert (t if isinstance(t, tuple) else t.sizes) == (
            j if isinstance(j, tuple) else j.sizes), (n, kw)


def logical_trees():
    return {
        "gpt2": (tgpt2.logical_axes(tgpt2.gpt2_tiny()),
                 jgpt2.logical_axes(jgpt2.gpt2_tiny())),
        "gpt2_moe": (tgpt2.logical_axes(tgpt2.gpt2_tiny(moe_experts=4)),
                     jgpt2.logical_axes(jgpt2.gpt2_tiny(moe_experts=4))),
        "llama": (tllama.logical_axes(tllama.llama_tiny()),
                  jllama.logical_axes(jllama.llama_tiny())),
    }


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("model", ["gpt2", "gpt2_moe", "llama"])
def test_logical_axes_match_jax(model):
    ours, ref = logical_trees()[model]
    assert dict(flat(ours)) == dict(flat(ref))


def placements_of(spec, ndim):
    """A JAX PartitionSpec as one placement per mesh dim (AXIS_ORDER)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(jmesh.AXIS_ORDER)
    for i, target in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for a in (target,) if isinstance(target, str) else (target or ()):
            out[jmesh.AXIS_ORDER.index(a)] = Shard(i)
    return tuple(out)


@pytest.mark.parametrize("rules", [None, {"layers": "pp"}, {"embed": ("dp", "fsdp")}])
@pytest.mark.parametrize("model", ["gpt2", "gpt2_moe", "llama"])
def test_spec_for_matches_jax(model, rules):
    """Every leaf of the three logical-axes trees: partition_spec is the
    reference's spec_for, and spec_for's placements shard the same dims
    over the same mesh axes."""
    ours, _ = logical_trees()[model]
    placed = tsharding.tree_specs(ours, rules)
    for name, axes in flat(ours):
        ref = jsharding.spec_for(axes, rules)
        assert tsharding.partition_spec(axes, rules) == tuple(ref), name
        assert dict(flat(placed))[name] == placements_of(ref, len(axes)), name


def test_stages_from_layers_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 3, 2)).astype(np.float32),
            "b": {"c": rng.normal(size=(8, 5)).astype(np.float32)}}
    ours = tpipeline.stages_from_layers(
        {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}}, 4)
    ref = jpipeline.stages_from_layers(tree, 4)
    for (n, o), (_, r) in zip(flat(ours), flat(ref)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=n)
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        tpipeline.stages_from_layers({"a": torch.zeros(8, 2)}, 3)


def tanh_stages(ws, h):
    for w in ws:
        h = torch.tanh(h @ w)
    return h


def jax_tanh_stages(ws, h):
    def body(h, w):
        return jnp.tanh(h @ w), None

    return jax.lax.scan(body, h, ws)[0]


@pytest.mark.parametrize("P_,M,L,B", [(4, 4, 8, 8), (2, 2, 4, 4), (3, 5, 6, 10), (1, 2, 2, 4)])
def test_pipeline_apply_matches_sequential(P_, M, L, B):
    """tests/test_pipeline.py:20-45 without a mesh: the pipeline equals
    the stages one after another, and JAX's pipeline_apply on the same
    numpy inputs."""
    D = 16
    rng = np.random.default_rng(0)
    layers = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    tl, tx = torch.from_numpy(layers), torch.from_numpy(x)
    got = tpipeline.pipeline_apply(
        tanh_stages, tpipeline.stages_from_layers(tl, P_), tx,
        num_stages=P_, num_microbatches=M)
    torch.testing.assert_close(got, tanh_stages(tl, tx), rtol=1e-5, atol=1e-6)
    ref = jpipeline.pipeline_apply(
        jax_tanh_stages, jpipeline.stages_from_layers(jnp.asarray(layers), P_),
        jnp.asarray(x), num_stages=P_, num_microbatches=M)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_pipeline_apply_grads_match():
    """tests/test_pipeline.py:48-75 without a mesh: gradients through the
    schedule equal the sequential ones and jax.grad's of the reference's
    pipeline_apply."""
    P_, L, D = 2, 4, 8
    rng = np.random.default_rng(1)
    layers = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(4, D)).astype(np.float32)
    tx = torch.from_numpy(x)

    def grads(pipelined):
        ws = torch.from_numpy(layers).requires_grad_(True)
        y = (tpipeline.pipeline_apply(
                tanh_stages, tpipeline.stages_from_layers(ws, P_), tx,
                num_stages=P_, num_microbatches=2)
             if pipelined else tanh_stages(ws, tx))
        (y ** 2).sum().backward()
        return ws.grad

    ref = jax.grad(lambda ws: jnp.sum(jpipeline.pipeline_apply(
        jax_tanh_stages, jpipeline.stages_from_layers(ws, P_), jnp.asarray(x),
        num_stages=P_, num_microbatches=2) ** 2))(jnp.asarray(layers))
    torch.testing.assert_close(grads(True), grads(False), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads(True).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-6)


def test_pipeline_apply_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        tpipeline.pipeline_apply(tanh_stages, torch.zeros(2, 1, 4, 4),
                                 torch.zeros(6, 4), num_stages=2,
                                 num_microbatches=4)


# --------------------------------------------------------------------------- #
# A process group of one rank, in this process
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    path = tmp_path_factory.mktemp("rdzv") / "file"
    tmesh.init_distributed("gloo", init_method=f"file://{path}", rank=0,
                           world_size=1, timeout_s=60)
    yield tmesh.make_mesh(tmesh.MeshSpec(), "cpu")
    dist.destroy_process_group()


def test_make_mesh_needs_the_world_the_spec_names(world_one):
    with pytest.raises(ValueError, match="needs 2 ranks, the process group has 1"):
        tmesh.make_mesh(tmesh.MeshSpec(dp=2), "cpu")
    assert world_one.mesh_dim_names == tmesh.AXIS_ORDER
    assert tmesh.mesh_spec(world_one) == tmesh.MeshSpec()


def test_local_rows(world_one):
    assert tmesh.local_rows(world_one, 6) == slice(0, 6)
    batch = ttrain.synthetic_batch(tgpt2.gpt2_tiny(), 4)
    assert tmesh.local_batch(world_one, batch)["tokens"].shape == (4, 128)


class CollectiveCounter:
    NAMES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")

    def __init__(self, monkeypatch):
        self.calls = {n: 0 for n in self.NAMES}
        for n in self.NAMES:
            monkeypatch.setattr(dist, n, self.wrap(n, getattr(dist, n)))

    def wrap(self, name, fn):
        def counted(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return counted


@pytest.mark.parametrize("cfg", [
    tgpt2.gpt2_tiny(dtype=torch.float32),
    tgpt2.gpt2_tiny(dtype=torch.float32, moe_experts=4, moe_top_k=2,
                    moe_capacity_factor=1.0),
    tllama.llama_tiny(dtype=torch.float32),
    tgpt2.gpt2_tiny(dtype=torch.float32, loss_chunk=32),
], ids=["gpt2", "gpt2_moe", "llama", "gpt2_chunked_loss"])
def test_world_one_mesh_runs_the_mesh_code_and_the_plain_step(world_one, cfg, monkeypatch):
    """A mesh of one device is no shortcut: its state holds DTensors with
    the rule table's placements, every step runs the collectives (on
    groups of one), and the result is the plain step's: the same loss,
    the grad norm within 1e-5 relative (the plain step's
    torch.linalg.vector_norm of the CPU's f32 is the less exact one: at
    gpt2_moe's first step 2.9e-6 from the norm in f64, the mesh step's
    sums of squares 3e-8), params
    after two steps (the second at lr > 0) within 1e-5, the tolerance of
    tests/test_torch_train_step.py (measured 1.2e-6: the clip factor
    carries the norm's rounding, and Adam's step of an entry whose
    gradient is near eps follows it)."""
    from torch.distributed.tensor import DTensor, Shard

    model = tgpt2 if isinstance(cfg, tgpt2.GPT2Config) else tllama
    make = (ttrain.make_gpt2_train_step if model is tgpt2
            else ttrain.make_llama_train_step)
    batches = [ttrain.synthetic_batch(cfg, 2, seed=s) for s in (0, 1)]
    runs = {}
    for path, mesh in (("plain", None), ("mesh", world_one)):
        bundle = make(cfg, ttrain.default_optimizer(warmup=1, total_steps=10),
                      torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
        counter = CollectiveCounter(monkeypatch)
        state, metrics = bundle.state, []
        for b in batches:
            state, m = bundle.step_fn(state, b)
            metrics.append(m)
        runs[path] = (metrics, state, dict(counter.calls))
    (pm, ps, pcalls), (mm, ms, mcalls) = runs["plain"], runs["mesh"]
    assert sum(pcalls.values()) == 0
    n = len(ttrain.param_leaves(ms["params"]))
    assert mcalls["all_reduce"] >= 2 * n
    assert min(mcalls.values()) > 0, mcalls
    leaves = dict(ttrain.named_leaves(ms["params"]))
    assert all(isinstance(d, DTensor) for d in leaves.values())
    embed = "wte" if model is tgpt2 else "lm_head"
    assert any(isinstance(p, Shard) for p in leaves[embed].placements)
    for a, b in zip(pm, mm):
        torch.testing.assert_close(b["loss"], a["loss"], rtol=1e-6, atol=0)
        torch.testing.assert_close(b["grad_norm"], a["grad_norm"], rtol=1e-5, atol=0)
    full = tsharding.gather_tree(ms["params"])
    for (name, p), (same, q) in zip(ttrain.named_leaves(ps["params"]),
                                    ttrain.named_leaves(full)):
        assert name == same
        torch.testing.assert_close(q, p.detach(), rtol=0, atol=1e-5)


# the tp collectives of one meshed step at world 1, by hand. Forward: the
# vocab-parallel embedding's sum (1), a row-parallel sum out of attention
# and out of the MLP in each layer (2 L), the cross-entropy's max and its
# [Σexp, target logit] sum (2). Backward: a column-parallel input's
# gradient sum into qkv and into the MLP in each layer (2 L), the LM
# head's input (1). The step: one sum of squares for each distinct set of
# axes that shards a tp-split leaf, and one broadcast over tp of each leaf
# held whole on every tp rank.
TP_COLLECTIVES = {
    # 2 layers; keys (fsdp, tp) and (tp,) [qkv_b, fc_b]; whole: wpe,
    # ln1/ln2 scale and bias, proj_b, out_b, lnf scale and bias
    "gpt2": (4 * 2 + 4) + 2 + 9,
    # keys (fsdp, tp), (tp,), (fsdp, ep, tp) [moe fc_w, out_w], (ep, tp)
    # [moe fc_b]; whole: as dense without out_b, plus moe router_w, out_b
    "gpt2_moe": (4 * 2 + 4) + 4 + 10,
    # the key (fsdp, tp) only; whole: attn_norm, mlp_norm, final_norm
    "llama": (4 * 2 + 4) + 1 + 3,
}


@pytest.mark.parametrize("name,cfg", [
    ("gpt2", tgpt2.gpt2_tiny(dtype=torch.float32)),
    ("gpt2_moe", tgpt2.gpt2_tiny(dtype=torch.float32, moe_experts=4,
                                 moe_top_k=2)),
    ("llama", tllama.llama_tiny(dtype=torch.float32)),
], ids=["gpt2", "gpt2_moe", "llama"])
def test_tp_collectives_of_a_step_equal_the_formula(world_one, name, cfg):
    """A one-rank mesh goes through the tensor-parallel code: each step
    runs the tp collectives counted above, on a group of one, and those
    over the other axes as before; the plain step runs none."""
    model = tgpt2 if isinstance(cfg, tgpt2.GPT2Config) else tllama
    make = (ttrain.make_gpt2_train_step if model is tgpt2
            else ttrain.make_llama_train_step)
    batch = ttrain.synthetic_batch(cfg, 2)
    for mesh in (None, world_one):
        bundle = make(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu", mesh=mesh)
        tmesh.collectives.clear()
        for _ in range(2):
            bundle.step_fn(bundle.state, batch)
        counted = dict(tmesh.collectives)
        if mesh is None:
            assert counted == {}
    assert counted["tp"] == 2 * TP_COLLECTIVES[name], counted
    assert counted["fsdp"] > 0 and counted["dp"] > 0


@pytest.mark.parametrize("cfg", [
    tgpt2.gpt2_tiny(dtype=torch.float32, remat=True, loss_chunk=32),
    tgpt2.gpt2_tiny(dtype=torch.float32, remat="dots"),
    tllama.llama_tiny(dtype=torch.float32, remat=True),
], ids=["gpt2_remat_chunked_loss", "gpt2_remat_dots", "llama_remat"])
def test_a_backward_on_another_thread_reruns_under_the_mesh(world_one, cfg):
    """On the card the autograd engine runs the backward on a thread of its
    own, where no mesh is entered: a checkpointed block and a chunk of the
    loss run again there under the mesh they ran under, with their tp
    collectives and the gradients of a backward under the mesh on this
    thread (the train step's), to f32 rounding: another thread's products
    sum in another order (4.8e-7 apart at most, measured)."""
    from concurrent.futures import ThreadPoolExecutor

    model = tgpt2 if isinstance(cfg, tgpt2.GPT2Config) else tllama
    batch = ttrain.synthetic_batch(cfg, 2)
    runs = {}
    for where in ("here", "thread"):
        params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = ttrain.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with tmesh.use_mesh(world_one):
            total, _ = model.loss_terms(params, batch["tokens"], batch["targets"], cfg)
            tmesh.collectives.clear()
            if where == "here":
                total.backward()
        if where == "thread":
            with ThreadPoolExecutor(1) as pool:
                pool.submit(total.backward).result()
        runs[where] = (dict(tmesh.collectives), [p.grad for p in leaves])
    assert runs["here"][0]["tp"] > 0
    assert runs["thread"][0] == runs["here"][0]
    for a, b in zip(runs["here"][1], runs["thread"][1]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)

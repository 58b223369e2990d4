"""One rank of a multi-process run of ray_tpu_torch's parallel/ (not a test
file: tests/test_torch_parallel_train.py starts it, one process a rank).

    python tests/torch_parallel_ranks.py WORKDIR RANK WORLD

Imports torch and ray_tpu_torch only (no JAX): the reference numbers are
computed by the parent and compared there. Reads WORKDIR/plans.json, a list
of plans, and for each train or forward plan WORKDIR/<name>.npz (the
initial params as "init/<leaf>", the batch as "tokens" and "targets"; an
xent plan's logits and targets); joins a gloo group
of WORLD ranks by a file:// rendezvous in WORKDIR, with a timeout, so that
a mismatched collective fails instead of hanging (a ring plan's q, k, v
and its mesh: ring attention on this rank's block); and writes
WORKDIR/<name>.<RANK>.npz and WORKDIR/<name>.<RANK>.json with what the
plan measured (and an MoE plan's routing, by layer call, to
WORKDIR/<name>.<RANK>.routing.npz).
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.ops import moe
from ray_tpu_torch.ops.cross_entropy import vocab_parallel_xent
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel import sharding, tensor
from ray_tpu_torch.train import train_step as ttrain

MODELS = {"gpt2": (gpt2, gpt2.gpt2_tiny, ttrain.make_gpt2_train_step),
          "llama": (llama, llama.llama_tiny, ttrain.make_llama_train_step)}
TIMEOUT_S = 60


def make_cfg(plan):
    _, tiny, _ = MODELS[plan["model"]]
    kw = dict(plan.get("cfg", {}))
    for k in ("dtype", "param_dtype"):
        if k in kw:
            kw[k] = getattr(torch, kw[k])
    return tiny(**kw)


def optimizer():
    return ttrain.default_optimizer(warmup=2, total_steps=10)


def bundle_from(plan, cfg, mesh, init):
    """The plan's meshed bundle, its params set to the full tree `init`
    (numpy, by dotted name) through shard_tree."""
    model, _, make = MODELS[plan["model"]]
    bundle = make(cfg, optimizer(), device="cpu", mesh=mesh)
    full = ttrain._unflatten(list(init), [torch.from_numpy(v) for v in init.values()])
    placed = sharding.shard_tree(mesh, full, model.logical_axes(cfg),
                                 bundle.rules)
    placed = dict(ttrain.named_leaves(placed))
    with torch.no_grad():
        for name, dst in ttrain.named_leaves(bundle.state["params"]):
            dst.to_local().copy_(placed[name].to_local())
    return bundle


def train_plan(plan, workdir: Path, rank: int):
    cfg = make_cfg(plan)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(**plan["mesh"]), "cpu")
    data = np.load(workdir / f"{plan['name']}.npz")
    init = {k[5:]: data[k] for k in data.files if k.startswith("init/")}
    batches = [{"tokens": t, "targets": y}
               for t, y in zip(data["tokens"], data["targets"])]
    bundle = bundle_from(plan, cfg, mesh, init)

    dropped = []        # per MoE layer call: choices dropped over the batch
    routing = {}        # per MoE layer call: its experts and kept choices

    def counting(r, capacity, rows, mesh_):
        g = moe._kept_global(r, capacity, rows, mesh_)
        routing[f"routing/expert/{len(dropped)}"] = g.expert.numpy()
        routing[f"routing/keep/{len(dropped)}"] = g.keep.numpy()
        d = (~g.keep).sum()
        dropped.append(int(mesh_lib.all_reduce(d, mesh_, mesh_lib.TOKEN_AXES)))
        return g

    moe._kept_global, moe._global_queue = moe._global_queue, counting
    mesh_lib.collectives.clear()
    state, metrics = bundle.state, []
    try:
        for batch in batches:
            state, m = bundle.step_fn(state, batch)
            metrics.append(m)
    finally:
        moe._global_queue = moe._kept_global
        del moe._kept_global
    out = {k: torch.stack([m[k] for m in metrics]).numpy()
           for k in ("loss", "grad_norm")}
    if routing:
        np.savez(workdir / f"{plan['name']}.{rank}.routing.npz", **routing)
    for name, d in ttrain.named_leaves(sharding.gather_tree(state["params"])):
        out["after/" + name] = d.numpy()
    meta = {"dropped": dropped, "leaves": {},
            "collectives": dict(mesh_lib.collectives)}
    opt = state["opt_state"]
    for (name, d), shard in zip(ttrain.named_leaves(state["params"]),
                                opt.param_groups[0]["params"]):
        with torch.no_grad():
            local = d.to_local()
        meta["leaves"][name] = {
            "placements": [repr(p) for p in d.placements],
            "global": list(d.shape), "local": list(local.shape),
            "moment": list(opt.state[shard]["mu"].shape),
            "shard_is_local": shard is local,
        }
    meta["tp_rank"] = mesh.get_local_rank("tp")
    if plan.get("multi_step"):
        meta["multi_step_equal"] = multi_step_equal(plan, cfg, mesh, init,
                                                    batches[0])
    return out, meta


def multi_step_equal(plan, cfg, mesh, init, batch) -> bool:
    """multi_step_fn over two stacked batches against step_fn twice, from
    the same params: bitwise the same metrics and params."""
    second = {k: np.roll(v, 1, axis=0) for k, v in batch.items()}
    a = bundle_from(plan, cfg, mesh, init)
    b = bundle_from(plan, cfg, mesh, init)
    ma = [a.step_fn(a.state, x)[1] for x in (batch, second)]
    _, mb = b.multi_step_fn(b.state, {k: np.stack([batch[k], second[k]])
                                      for k in batch})
    same = all(torch.equal(torch.stack([m[k] for m in ma]), mb[k])
               for k in ("loss", "grad_norm"))
    for p, q in zip(ttrain.param_leaves(a.state["params"]),
                    ttrain.param_leaves(b.state["params"])):
        same = same and torch.equal(p.to_local(), q.to_local())
    return bool(same)


def refusal_plan(plan, workdir: Path, rank: int):
    """Each refusal of a mesh plan, as the exception's type and message."""
    results = {}

    def expect(name, fn):
        try:
            fn()
            results[name] = "no exception"
        except (ValueError, NotImplementedError) as e:
            results[name] = f"{type(e).__name__}: {e}"

    dp2pp2 = mesh_lib.make_mesh(mesh_lib.MeshSpec(dp=2, pp=2), "cpu")
    expect("moe_with_pp", lambda: ttrain.make_gpt2_train_step(
        gpt2.gpt2_tiny(moe_experts=4, moe_top_k=2), device="cpu", mesh=dp2pp2))
    expect("n_layer_not_divisible", lambda: ttrain.make_gpt2_train_step(
        gpt2.gpt2_tiny(n_layer=3), device="cpu", mesh=dp2pp2))

    def microbatches():
        cfg = gpt2.gpt2_tiny(dtype=torch.float32, pipeline_microbatches=3)
        bundle = ttrain.make_gpt2_train_step(cfg, device="cpu", mesh=dp2pp2)
        bundle.step_fn(bundle.state, ttrain.synthetic_batch(cfg, 8))
    expect("batch_not_divisible_by_microbatches", microbatches)
    tp4 = mesh_lib.make_mesh(mesh_lib.MeshSpec(tp=4), "cpu")
    expect("tp_not_dividing_kv_heads", lambda: ttrain.make_llama_train_step(
        llama.llama_tiny(), device="cpu", mesh=tp4))
    cfg = llama.llama_tiny()
    expect("shard_tree_tp_not_dividing", lambda: sharding.shard_tree(
        tp4, llama.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
        llama.logical_axes(cfg)))
    cp4 = mesh_lib.make_mesh(mesh_lib.MeshSpec(cp=4), "cpu")
    expect("seq_len_not_divisible_by_cp", lambda: ttrain.make_gpt2_train_step(
        gpt2.gpt2_tiny(seq_len=126), device="cpu", mesh=cp4))

    def batch_not_divisible_by_cp():
        cfg = gpt2.gpt2_tiny(dtype=torch.float32)
        bundle = ttrain.make_gpt2_train_step(cfg, device="cpu", mesh=cp4)
        batch = ttrain.synthetic_batch(cfg, 2)
        bundle.step_fn(bundle.state, {k: v[:, :126] for k, v in batch.items()})
    expect("batch_seq_not_divisible_by_cp", batch_not_divisible_by_cp)
    return {}, results


def ring_plan(plan, workdir: Path, rank: int):
    """ring_attention over the plan's mesh on this rank's block of the
    global q, k, v [B, S, H, hd] (rows over dp·fsdp, positions over cp,
    heads over tp), causal or not: its output, the gradients of
    Σ sin(o) over the block, where the block lies, and the exchanges run
    over cp."""
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(**plan["mesh"]), "cpu")
    data = np.load(workdir / f"{plan['name']}.npz")
    B, S, H, _ = data["q"].shape
    rows = mesh_lib.local_rows(mesh, B)
    cols = mesh_lib.local_positions(mesh, S)
    per = H // mesh_lib.axis_size(mesh, ("tp",))
    heads = slice(mesh.get_local_rank("tp") * per, (mesh.get_local_rank("tp") + 1) * per)
    q, k, v = (torch.from_numpy(data[n])[rows, cols, heads].transpose(1, 2)
               .contiguous().requires_grad_(True) for n in "qkv")
    mesh_lib.collectives.clear()
    o = ring_attention(q, k, v, mesh, causal=plan["causal"])
    o.float().sin().sum().backward()
    out = {"o": o.detach().transpose(1, 2).numpy(),
           **{f"d{n}": x.grad.transpose(1, 2).numpy()
              for n, x in zip("qkv", (q, k, v))}}
    where = {n: [s.start, s.stop] for n, s in
             (("rows", rows), ("cols", cols), ("heads", heads))}
    return out, {**where, "cp_rank": mesh.get_local_rank("cp"),
                 "collectives": dict(mesh_lib.collectives)}


def forward_plan(plan, workdir: Path, rank: int):
    """The model's forward over the plan's mesh, from the full initial
    params placed by shard_tree: this rank's working tree under use_mesh,
    its [B, S, V/tp] logits gathered over tp."""
    model, _, _ = MODELS[plan["model"]]
    cfg = make_cfg(plan)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(**plan["mesh"]), "cpu")
    data = np.load(workdir / f"{plan['name']}.npz")
    init = {k[5:]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith("init/")}
    placed = sharding.shard_tree(
        mesh, ttrain._unflatten(list(init), list(init.values())),
        model.logical_axes(cfg))
    with torch.no_grad(), mesh_lib.use_mesh(mesh):
        local = model.forward(sharding.working_tree(placed),
                              torch.from_numpy(data["tokens"]), cfg)
        logits = tensor.gather_vocab(local, mesh)
    return {"logits": logits.numpy()}, {"local": list(local.shape)}


def xent_plan(plan, workdir: Path, rank: int):
    """vocab_parallel_xent over MeshSpec(tp=WORLD): this rank's shard of
    the full logits (f32 and bf16), each position's nll weighted by a
    given gradient; the nll and this rank's gradient."""
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(tp=plan["tp"]), "cpu")
    data = np.load(workdir / f"{plan['name']}.npz")
    r = mesh.get_local_rank("tp")
    n = data["logits"].shape[-1] // plan["tp"]
    targets = torch.from_numpy(data["targets"])
    out = {}
    for dtype in ("float32", "bfloat16"):
        full = torch.from_numpy(data["logits"]).to(getattr(torch, dtype))
        local = full[..., r * n:(r + 1) * n].clone().requires_grad_(True)
        nll = vocab_parallel_xent(local, targets, mesh)
        (nll * torch.from_numpy(data["g"])).sum().backward()
        out[f"nll/{dtype}"] = nll.detach().numpy()
        out[f"grad/{dtype}/{r}"] = local.grad.float().numpy()
    return out, {"tp_rank": r}


def main() -> int:
    workdir, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(2)
    # the embedding's backward accumulates repeated tokens in a run-dependent
    # order on several threads: the bitwise checks want one order
    torch.use_deterministic_algorithms(True)
    mesh_lib.init_distributed("gloo", init_method=f"file://{workdir}/rdzv",
                              rank=rank, world_size=world, timeout_s=TIMEOUT_S)
    try:
        for plan in json.loads((workdir / "plans.json").read_text()):
            run = {"train": train_plan, "refusals": refusal_plan,
                   "forward": forward_plan, "xent": xent_plan,
                   "ring": ring_plan}[plan["kind"]]
            out, meta = run(plan, workdir, rank)
            np.savez(workdir / f"{plan['name']}.{rank}.npz", **out)
            (workdir / f"{plan['name']}.{rank}.json").write_text(json.dumps(meta))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

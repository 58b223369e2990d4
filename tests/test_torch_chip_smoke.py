"""The checks of chip_smoke.py that run on the CPU too.

chip_smoke.py holds the backward kernel against `mha_backward_plain`, which
rounds as the TPU kernel does, by mean error over mean magnitude
(`MEAN_REL_TOL`). `scale_on_sums` below is another rounding: the scale,
rounded to bf16, applied to the f32 sums q.k^T, ds^T.q and ds.k instead of
to q and k before the products: the rounding of a kernel that takes q and
k unscaled into its products. These tests show that the check accepts
it where the scale is a power of two (hd 64, where it is the plain version
itself) and rejects it at hd 128, where the max-error check alone
(`GRAD_REL_TOL`) lets it pass. They also drive the reader of the SASS's
highest register on cuobjdump-like text.
"""

import importlib.util
import pathlib
import re
import subprocess
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tattn

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scale_on_sums(q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True):
    """mha_backward_plain with the scale, rounded to bf16, multiplying the
    f32 sums q.k^T, ds^T.q and ds.k rather than q and k before the
    products."""
    Sq, Skv, hd = q.shape[2], k.shape[2], q.shape[3]
    sc = float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    qf, kf, dof = q.float(), k.float(), do.float()
    p = torch.exp(qf @ kf.transpose(-1, -2) * sc - lse[..., None])
    if causal:
        rows = q_off + torch.arange(Sq)[:, None]
        cols = kv_off + torch.arange(Skv)[None, :]
        p = p.masked_fill(rows < cols, 0.0)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = (p * (dp - tattn._delta(o, do)[..., None])).to(q.dtype).float()
    dk = ds.transpose(-1, -2) @ qf * sc
    dq = ds @ kf * sc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_inputs(seed, hd, B=1, H=2, S=256):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, hd), dtype=np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = tattn.mha_forward_plain(q, k, v)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("causal,offsets", [
    (True, (0, 0)), (False, (0, 0)), (True, (128, 0)),
])
def test_scale_on_sums_is_the_plain_backward_at_hd64(smoke, causal, offsets):
    q, k, v, o, lse, do = backward_inputs(0, 64)
    args = (q, k, v, o, lse, do, *offsets)
    model = scale_on_sums(*args, causal=causal)
    plain = tattn.mha_backward_plain(*args, causal=causal)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
        assert smoke.mean_rel_err(a, b) <= smoke.MEAN_REL_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_mean_error_check_separates_the_rounding_points_at_hd128(smoke, causal):
    q, k, v, o, lse, do = backward_inputs(1, 128)
    model = scale_on_sums(q, k, v, o, lse, do, causal=causal)
    plain = tattn.mha_backward_plain(q, k, v, o, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), model, plain):
        err = smoke.mean_rel_err(a, b)
        assert err > 10 * smoke.MEAN_REL_TOL, (name, err)
        assert smoke.rel_err(a, b) <= smoke.GRAD_REL_TOL, name


def test_sass_highest_register_per_function(smoke, monkeypatch):
    sass = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116flash_bwd_kernelILi64EEEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD R181, R2, R237, RZ ;
        /*0020*/                   STS.128 [R9+0x400], R20 ;
\t\tFunction : _Z4castPKfP13__nv_bfloat16xf
        /*0000*/                   MOV R19, R3 ;
"""
    monkeypatch.setattr(_build, "_nvcc", lambda: "/cuda/bin/nvcc")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=sass)

    monkeypatch.setattr(subprocess, "run", fake_run)
    top = smoke.sass_highest_registers(pathlib.Path("lib.so"))
    assert calls == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    assert top == {"_ZN12_GLOBAL__N_116flash_bwd_kernelILi64EEEv": "R237",
                   "_Z4castPKfP13__nv_bfloat16xf": "R19"}


def test_executed_flops_of_the_moe_training_path(smoke):
    """gpt2_124m(moe_experts=8) at B 24 x 1024: C = ceil(2 * 24576 / 8 *
    1.25) = 7680, so the card runs 8 * 7680 / 24576 = 2.5 expert slots a
    token; by hand, 6 * (67,880,448 non-expert parameters + 2.5 *
    56,669,184 parameters of one expert in every layer) + 113,246,208 for
    attention (12 * L * D * S). The JAX formula counts all 8 experts."""
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.gpt2_124m(moe_experts=8)
    one_expert = 12 * (768 * 3072 + 3072 + 3072 * 768 + 768)
    assert one_expert == 56_669_184
    assert gpt2.param_count(cfg) - 8 * one_expert == 67_880_448
    by_hand = 6 * (67_880_448 + 2.5 * 56_669_184) + 12 * 12 * 768 * 1024
    assert by_hand == 1_370_566_656
    assert smoke.executed_flops_per_token(gpt2, cfg, 24 * 1024) == by_hand
    assert gpt2.flops_per_token(cfg) == 6 * 521_233_920 + 113_246_208
    dense = gpt2.gpt2_124m()
    assert (smoke.executed_flops_per_token(gpt2, dense, 24 * 1024)
            == gpt2.flops_per_token(dense))


def test_routing_flip_counter_on_hand_made_routings(smoke):
    """Two layers of 3 tokens, top-2: run b chooses expert 3 instead of 2
    for token 1's second choice in layer 0, and keeps token 2's first
    choice in layer 1 where run a dropped it."""
    def routing(expert, keep):
        return types.SimpleNamespace(expert=torch.tensor(expert),
                                     keep=torch.tensor(keep))

    kept = [[True, True]] * 3
    a = [routing([[0, 1], [1, 2], [2, 0]], kept),
         routing([[1, 0], [0, 1], [3, 2]], [[True, True], [True, True],
                                            [False, True]])]
    b = [routing([[0, 1], [1, 3], [2, 0]], kept),
         routing([[1, 0], [0, 1], [3, 2]], kept)]
    assert smoke.routing_flips(a, b) == {
        "decisions": 12, "expert_differs": 1, "drop_differs": 1,
        "expert_differs_by_layer": [1, 0], "drop_differs_by_layer": [0, 1],
        "dropped": 1}
    same = smoke.routing_flips(a, a)
    assert same["expert_differs"] == same["drop_differs"] == 0
    with pytest.raises(SystemExit, match="routing recorded"):
        smoke.routing_flips(a, b[:1])


def test_forced_routing_replays_a_recorded_routing(smoke):
    """A forward under forced_routing of its own recorded routing gives the
    same logits; route is restored after the block."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import moe

    cfg = gpt2.gpt2_tiny(moe_experts=4)
    params = gpt2.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 64)))
    routing = {"kernel": []}
    own = moe.route
    with torch.inference_mode():
        with smoke.routing_of(gpt2, cfg, routing, "kernel"):
            logits = gpt2.forward(params, toks, cfg)
        assert len(routing["kernel"]) == cfg.n_layer
        with smoke.forced_routing(routing["kernel"]):
            assert moe.route is not own
            assert torch.equal(gpt2.forward(params, toks, cfg), logits)
    assert moe.route is own


def test_recorded_routing_sees_every_moe_layer(smoke):
    """recorded_routing wraps models.gpt2's MoE layer for the block only:
    one (expert, keep) pair per layer, the same logits as without it."""
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.gpt2_tiny(moe_experts=4)
    params = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 64)))
    sink = []
    with torch.inference_mode():
        with smoke.recorded_routing(gpt2, sink):
            logits = gpt2.forward(params, toks, cfg)
        assert torch.equal(logits, gpt2.forward(params, toks, cfg))
    assert gpt2.moe_mlp.__name__ == "moe_mlp"
    assert len(sink) == cfg.n_layer
    assert all(r.expert.shape == (128, 2) and r.keep.dtype == torch.bool
               for r in sink)


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """A one-rank gloo process group in this process and its mesh, as the
    [parallel] phase makes one over NCCL on the card."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh as mesh_lib

    path = tmp_path_factory.mktemp("rdzv") / "file"
    mesh_lib.init_distributed("gloo", init_method=f"file://{path}", rank=0,
                              world_size=1, timeout_s=60)
    yield mesh_lib.make_mesh(mesh_lib.MeshSpec(), "cpu")
    dist.destroy_process_group()


def test_parallel_phase_holds_the_mesh_step_to_the_plain_step(smoke, world_one):
    """train_run over the mesh and without it, at gpt2_tiny (f32) on the
    CPU: check_mesh_against_plain accepts them, and rejects a mesh run
    whose loss moved by 1e-5 or one of whose gradients doubled."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import make_gpt2_train_step, synthetic_batch

    cfg = gpt2.gpt2_tiny(dtype=torch.float32)
    batch = synthetic_batch(cfg, 2, seed=0)
    plain = smoke.train_run(make_gpt2_train_step, cfg, batch, "cpu", 2)
    meshed = smoke.train_run(make_gpt2_train_step, cfg, batch, "cpu", 2, world_one)
    assert len(meshed["step_ms"]) == 2 and meshed["loss"][-1] < meshed["first"]["loss"]
    assert meshed["launches"] == {"flash_fwd": 0, "flash_bwd": 0}   # plain versions
    errs = smoke.check_mesh_against_plain("test", plain, meshed)
    assert errs["loss"] == 0 and errs["worst_grad_rel_err"] <= 1e-6
    assert set(meshed["grads"]) == set(plain["grads"]) and len(plain["grads"]) == 16
    moved = {**meshed, "first": {**meshed["first"],
                                 "loss": meshed["first"]["loss"] * (1 + 1e-5)}}
    doubled = {**meshed, "grads": {**meshed["grads"],
                                   "wpe": 2 * meshed["grads"]["wpe"]}}
    for bad in (moved, doubled):
        with pytest.raises(SystemExit, match="mesh step disagrees"):
            smoke.check_mesh_against_plain("test", plain, bad)


def test_pipeline_check_on_the_cpu(smoke):
    """pipeline_and_sequential at gpt2_tiny (f32): 2 stages of one layer, 4
    microbatches of 4 rows, the same loss and gradients as the blocks one
    after another; no kernel launches on the CPU."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import synthetic_batch

    cfg = gpt2.gpt2_tiny(dtype=torch.float32)
    out = smoke.pipeline_and_sequential(cfg, synthetic_batch(cfg, 4), "cpu",
                                        2, 4, repeats=1)
    assert abs(out["loss"] - out["sequential_loss"]) <= 1e-6
    assert out["worst_grad_rel_err"] <= 1e-5
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert set(out["ms"]) == {"pipeline", "sequential"}


def test_multi_card_run_says_when_it_did_not_take_place(smoke, capsys):
    smoke.multi_card("no card", {})
    assert "multi-card run: did not take place (one card" in capsys.readouterr().out


def test_tp_collectives_formula(smoke):
    """tp_collectives_per_step by hand: 4 a layer (2 row-parallel sums in
    the forward, 2 column-parallel gradient sums in the backward), the
    embedding's sum, the head's gradient sum, the loss's 2, then a norm
    sum for each distinct set of axes sharding a tp-split leaf and a
    broadcast of each leaf held whole over tp."""
    from ray_tpu_torch.models import gpt2, llama

    # GPT-2: keys (fsdp, tp), (tp,); whole: wpe, ln1/ln2 scale and bias,
    # proj_b, out_b, lnf scale and bias
    assert smoke.tp_collectives_per_step(gpt2, gpt2.gpt2_124m()) == 4 * 12 + 4 + 2 + 9
    # MoE: keys also (fsdp, ep, tp), (ep, tp); whole: router_w and the
    # experts' out_b instead of out_b
    assert smoke.tp_collectives_per_step(
        gpt2, gpt2.gpt2_124m(moe_experts=8)) == 4 * 12 + 4 + 4 + 10
    # Llama: key (fsdp, tp); whole: the three RMSNorm scales
    assert smoke.tp_collectives_per_step(llama, llama.llama_1b()) == 4 * 22 + 4 + 1 + 3
    # a checkpointed block's recomputed forward stops after the last tensor
    # it saved: the sum out of attention runs again, the MLP's does not
    assert smoke.tp_collectives_per_step(
        llama, llama.llama_1b(remat=True)) == 5 * 22 + 4 + 1 + 3


@pytest.mark.parametrize("remat", [False, True])
def test_tp_collectives_formula_counts_a_step(smoke, world_one, remat):
    """The formula against the collectives a one-rank mesh step runs."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import make_gpt2_train_step, synthetic_batch

    cfg = gpt2.gpt2_tiny(dtype=torch.float32, remat=remat)
    run = smoke.train_run(make_gpt2_train_step, cfg, synthetic_batch(cfg, 2),
                          "cpu", 1, world_one)
    assert run["collectives"]["tp"] == 2 * smoke.tp_collectives_per_step(gpt2, cfg)


def test_parallel_tp_phase_on_the_cpu(smoke, world_one, capsys, monkeypatch):
    """mesh_against_plain, the [parallel-tp] phase's function, at llama_tiny
    (f32) over a one-rank gloo mesh: the mesh step held to the plain step,
    no kernel launches on the CPU, the tp collectives the formula's; a
    mesh run that ran other collectives than the formula says fails."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.train_step import make_llama_train_step

    cfg = llama.llama_tiny(dtype=torch.float32)
    run = smoke.mesh_against_plain("card", "parallel-tp", "llama_tiny", llama,
                                   make_llama_train_step, cfg, 2, 2, world_one,
                                   device="cpu")
    assert run["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert run["collectives"]["tp"] == 3 * smoke.tp_collectives_per_step(llama, cfg)
    out = capsys.readouterr().out
    assert "collectives over tp: 48 in 3 steps (the formula: 48)" in out
    assert '"mesh_tokens_per_s"' in out
    formula = smoke.tp_collectives_per_step
    monkeypatch.setattr(smoke, "tp_collectives_per_step",
                        lambda model, cfg: formula(model, cfg) + 1)
    with pytest.raises(SystemExit, match="collectives over tp"):
        smoke.mesh_against_plain("card", "parallel-tp", "llama_tiny", llama,
                                 make_llama_train_step, cfg, 2, 0, world_one,
                                 device="cpu")


def test_remat_against_mesh_over_gloo(smoke, world_one, monkeypatch):
    """The [parallel-tp] remat step on llama_tiny at world 1 over gloo: held
    to the meshed step without remat (the same loss, the tp collectives of
    the formula with remat, no kernel launched off the card); a rerun
    left without the mesh, which runs fewer collectives, fails it."""
    from ray_tpu_torch.models import common, llama
    from ray_tpu_torch.train.train_step import make_llama_train_step

    cfg = llama.llama_tiny(dtype=torch.float32)
    ref = smoke.mesh_against_plain("card", "parallel-tp", "llama_tiny", llama,
                                   make_llama_train_step, cfg, 2, 0, world_one,
                                   device="cpu")
    remat = replace(cfg, remat=True)
    launches = smoke.remat_against_mesh("card", world_one, ref, remat, 2, device="cpu")
    assert launches == {"flash_fwd": 0, "flash_bwd": 0}
    monkeypatch.setattr(common, "current_mesh", lambda: None)
    with pytest.raises(SystemExit, match="remat step"):
        smoke.remat_against_mesh("card", world_one, ref, remat, 2, device="cpu")


def test_rank_attention_shape_of_each_multi_card_plan(smoke):
    """The flash kernels' shape on one rank of each multi-card plan: the
    batch over dp·fsdp (and a pipeline's microbatches), the heads and kv
    heads over tp, the sequence over cp (a ring chunk, or on the gathered
    path the queries' chunk); no plan on one card."""
    assert smoke.multi_card_plans(1) == []
    shapes = {p["name"]: smoke.rank_attention_shape(p)
              for count in (2, 4) for p in smoke.multi_card_plans(count)}
    assert shapes == {
        "gpt2_124m_fsdp2": ((12, 12, 1024, 64), 12),
        "llama_1b_tp2": ((8, 16, 2048, 64), 4),
        "gpt2_124m_cp2": ((24, 12, 512, 64), 12),
        "gpt2_124m_fsdp4": ((6, 12, 1024, 64), 12),
        "llama_1b_tp4": ((8, 8, 2048, 64), 2),
        "gpt2_124m_cp4": ((24, 12, 256, 64), 12),
        "gpt2_124m_fsdp2tp2": ((12, 6, 1024, 64), 6),
        "llama_1b_cp2tp2": ((8, 16, 1024, 64), 4),
        "gpt2_124m_moe8_cp2": ((24, 12, 512, 64), 12),
        "gpt2_124m_moe8_fsdp2cp2": ((12, 12, 512, 64), 12),
        "gpt2_124m_pallas_cp2": ((24, 12, 512, 64), 12),
        # 4 microbatches of the 24 rows
        "gpt2_124m_pp2cp2": ((6, 12, 512, 64), 12),
        "llama_1b_pp2tp2": ((8, 16, 2048, 64), 4),
    }
    # the cp plans' meshes hold as many ranks as the cards
    for count in (2, 4):
        for p in smoke.multi_card_plans(count):
            assert np.prod(list(p["mesh"].values())) <= count, p


def test_cp_collectives_formula(smoke):
    """cp_collectives_per_step by hand: the ring's cp − 1 rotations forward
    and cp backward a layer (cp − 1 more forward under remat True or
    "dots"; none on a cp group of one), a gradient sum a leaf, the count's
    and the loss's."""
    from ray_tpu_torch.models import gpt2, llama

    # GPT-2: 16 leaves; llama: 12
    assert smoke.cp_collectives_per_step(gpt2, gpt2.gpt2_124m(), 1) == 16 + 2
    assert smoke.cp_collectives_per_step(gpt2, gpt2.gpt2_124m(), 4) == 12 * 7 + 16 + 2
    assert smoke.cp_collectives_per_step(
        gpt2, gpt2.gpt2_124m(remat=True), 2) == 12 * 4 + 16 + 2
    assert smoke.cp_collectives_per_step(
        gpt2, gpt2.gpt2_124m(remat="dots"), 2) == 12 * 4 + 16 + 2
    assert smoke.cp_collectives_per_step(llama, llama.llama_1b(), 2) == 22 * 3 + 12 + 2


@pytest.mark.parametrize("cp,causal", [(1, True), (2, True), (4, True), (4, False)])
def test_ring_launches_formula_counts_the_schedule(smoke, monkeypatch, cp, causal):
    """ring_launches against the kernel calls a virtual ring of cp chunks
    makes on the CPU (the wrappers are counted here in their place), and
    plain_ring, which the [ring] phase holds the kernels' schedule to,
    gives the same schedule on the plain versions."""
    from ray_tpu_torch.ops import ring_attention as R

    calls = []
    for name in ("_mha_forward_bhsd", "_mha_backward_bhsd"):
        fn = getattr(R, name)
        monkeypatch.setattr(R, name, lambda *a, fn=fn, name=name, **kw: (
            calls.append(name), fn(*a, **kw))[1])
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 32, 16, generator=g) for _ in range(4))

    def run():
        chunks = [[c.contiguous().requires_grad_(True) for c in x.chunk(cp, 2)]
                  for x in (q, k, v)]
        out = R.virtual_ring_attention(*chunks, causal=causal)
        torch.autograd.backward(out, [c.contiguous() for c in do.chunk(cp, 2)])
    run()
    want = smoke.ring_launches(cp, causal)
    assert calls.count("_mha_forward_bhsd") == calls.count("_mha_backward_bhsd") == want
    o, grads = smoke.ring_run(q, k, v, do, cp)
    with smoke.plain_ring():
        o_p, grads_p = smoke.ring_run(q, k, v, do, cp)
    dist = smoke.ring_distance(o, grads, o_p, grads_p)
    assert dist["o"] == 0 and max(dist["rel"].values()) == 0, dist


def test_parallel_cp_phase_on_the_cpu(smoke, world_one, capsys):
    """mesh_against_plain, the [parallel-cp] phase's function, at gpt2_tiny
    (f32) with attention_impl "ring" over a one-rank gloo mesh, the plain
    step on "auto": held to the plain step, no kernel launched on the CPU,
    the collectives over cp the formula's (no rotation on a group of one:
    the 16 gradient sums and the count's and the loss's); a "ring" config
    without a plain one fails, as it must: it needs a mesh."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import make_gpt2_train_step

    cfg = gpt2.gpt2_tiny(dtype=torch.float32, attention_impl="ring")
    plain = gpt2.gpt2_tiny(dtype=torch.float32)
    run = smoke.mesh_against_plain("card", "parallel-cp", "gpt2_tiny", gpt2,
                                   make_gpt2_train_step, cfg, 2, 2, world_one,
                                   device="cpu", plain_cfg=plain)
    assert run["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert run["collectives"]["cp"] == 3 * smoke.cp_collectives_per_step(gpt2, cfg, 1) == 3 * 18
    assert "collectives over cp: 54 in 3 steps (the formula: 54)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs a mesh with a cp axis"):
        smoke.mesh_against_plain("card", "parallel-cp", "gpt2_tiny", gpt2,
                                 make_gpt2_train_step, cfg, 2, 0, world_one,
                                 device="cpu")


def test_multi_card_ranks_over_gloo(smoke):
    """run_ranks and mesh_rank, the processes of a multi-card run, over
    gloo on the CPU: llama_tiny over tp 2 against the same plan at world
    1. Both ranks report the same first loss, near world 1's (the
    row-parallel sums round in another order); the collectives over tp
    are the formula's for the 1 + TRAIN_STEPS steps, no kernel launched
    (plain versions on the CPU); hold_to_world_one accepts both and
    rejects a world-1 loss that moved."""
    from ray_tpu_torch.models import llama

    plan = dict(model="llama", config="llama_tiny", batch=2)
    one = smoke.run_ranks({**plan, "name": "test_w1", "mesh": {}}, 1,
                          backend="gloo", device="cpu")
    two = smoke.run_ranks({**plan, "name": "test_tp2", "mesh": {"tp": 2}}, 2,
                          backend="gloo", device="cpu")
    assert two[0]["first"]["loss"] == two[1]["first"]["loss"]
    assert abs(two[0]["first"]["loss"] - one[0]["first"]["loss"]) <= smoke.LOSS_TOL
    want = (1 + smoke.TRAIN_STEPS) * smoke.tp_collectives_per_step(
        llama, llama.llama_tiny(remat=False))
    for run in one + two:
        assert run["collectives"]["tp"] == want
        assert run["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
        assert run["peak_memory_bytes"] is None
    # the multi-card check holds each run to world 1, a tp group of one
    # included, and fails one whose loss moved
    for p, ranks in (({**plan, "name": "test_w1", "mesh": {}}, one),
                     ({**plan, "name": "test_tp2", "mesh": {"tp": 2}}, two)):
        smoke.hold_to_world_one("card", p, ranks, one[0], device="cpu")
    moved = {**one[0], "first": {**one[0]["first"],
                                 "loss": one[0]["first"]["loss"] + 0.01}}
    with pytest.raises(SystemExit, match="disagrees with the world-1 step"):
        smoke.hold_to_world_one("card", {**plan, "name": "test_tp2",
                                         "mesh": {"tp": 2}}, two, moved,
                                device="cpu")


def test_multi_card_cp_ranks_over_gloo(smoke, capfd):
    """A multi-card cp plan's processes over gloo on the CPU: gpt2_tiny
    over cp 2 (the ring between two processes) against the same model at
    world 1, held by hold_to_world_one: the same first loss on both
    ranks, near world 1's; each rank's cp index and the collectives over
    cp of the formula, (cp − 1) + cp rotations a layer a step. Under
    --profile (the plan's "profile") every rank profiles one more step
    (a step on some ranks only would leave the others' collectives
    unmatched)."""
    from ray_tpu_torch.models import gpt2

    plan = dict(model="gpt2", config="gpt2_tiny", batch=2)
    one = smoke.run_ranks({**plan, "name": "test_cp_w1", "mesh": {}}, 1,
                          backend="gloo", device="cpu")
    two = smoke.run_ranks({**plan, "name": "test_cp2", "mesh": {"cp": 2},
                           "profile": True}, 2, backend="gloo", device="cpu")
    out = capfd.readouterr().out
    assert "[profile] one test_cp2 rank 0 step" in out
    assert "[profile] one test_cp2 rank 1 step" in out
    assert [r["cp_rank"] for r in two] == [0, 1]
    cfg = gpt2.gpt2_tiny(remat=False)
    assert two[0]["collectives"]["cp"] == (1 + smoke.TRAIN_STEPS) * (
        2 * 3 + 16 + 2) == (1 + smoke.TRAIN_STEPS) * smoke.cp_collectives_per_step(gpt2, cfg, 2)
    smoke.hold_to_world_one("card", {**plan, "name": "test_cp2", "mesh": {"cp": 2}},
                            two, one[0], device="cpu")


def test_cp_collectives_formula_of_the_new_paths(smoke):
    """cp_collectives_per_step on the gathered path (an all-gather and a
    reduce-scatter a layer, a group of one included), with MoE blocks (the
    queue's all-gather and the aux loss's two sums a layer) and in a
    GPT-2 pipeline (a rank's L/pp layers for each microbatch); the
    launches a rank makes a step by launches_per_step."""
    from ray_tpu_torch.models import gpt2, llama

    pallas = gpt2.gpt2_124m(attention_impl="pallas")
    assert smoke.cp_collectives_per_step(gpt2, pallas, 1) == 12 * 2 + 16 + 2
    assert smoke.cp_collectives_per_step(gpt2, replace(pallas, remat=True), 2) == 12 * 3 + 18
    assert smoke.cp_collectives_per_step(
        llama, llama.llama_1b(attention_impl="xla"), 2) == 22 * 2 + 12 + 2
    moe = gpt2.gpt2_124m(moe_experts=8)
    assert smoke.cp_collectives_per_step(gpt2, moe, 1) == 12 * 3 + 17 + 2
    assert smoke.cp_collectives_per_step(gpt2, moe, 2) == 12 * (1 + 2 + 3) + 17 + 2
    pipe = gpt2.gpt2_124m(pipeline_microbatches=4)
    assert smoke.cp_collectives_per_step(gpt2, pipe, 2, pp=2) == 6 * 4 * 3 + 16 + 2
    # Llama runs no pipeline: every layer on every pp rank
    assert smoke.cp_collectives_per_step(llama, llama.llama_1b(), 1, pp=2) == 12 + 2
    assert smoke.launches_per_step(gpt2, pipe, 2, 1, pp=2) == 6 * 4 * 2
    assert smoke.launches_per_step(gpt2, pallas, 4, 3) == 12
    assert smoke.launches_per_step(llama, llama.llama_1b(attention_impl="xla"), 2, 1) == 0
    assert smoke.launches_per_step(llama, llama.llama_1b(), 1, 0, pp=2) == 22


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_gathered_launches_formula_counts_the_calls(smoke, monkeypatch, cp):
    """gathered_launches against the kernel calls a virtual gathered
    attention of cp chunks makes on the CPU (the wrappers are counted here
    in their place); gathered_schedule's calls made directly give the
    autograd path's output and gradients, bitwise, on the plain versions
    (the [gathered] phase holds the kernels' to them on the card)."""
    from ray_tpu_torch.ops import attention as A

    calls = []
    for name in ("_mha_forward_bhsd", "_mha_backward_bhsd"):
        fn = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, fn=fn, name=name, **kw: (
            calls.append(name), fn(*a, **kw))[1])
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(2, 4, 32, 16, generator=g) for _ in range(2))
    k, v = (torch.randn(2, 2, 32, 16, generator=g) for _ in range(2))
    o, grads = smoke.gathered_run(q, k, v, do, cp)
    want = smoke.gathered_launches(cp)
    assert calls.count("_mha_forward_bhsd") == calls.count("_mha_backward_bhsd") == want
    fwd, grads_s = smoke.gathered_schedule(q, k, v, do, cp, plain=True)
    assert torch.equal(torch.cat([o_c for o_c, _ in fwd], 2), o)
    for a, b in zip(grads, grads_s):
        assert torch.equal(a, b)
    assert grads[1].shape == k.shape


def test_parallel_gathered_and_moe_cp_phases_on_the_cpu(smoke, world_one, capsys):
    """mesh_against_plain, the [parallel-gathered] and [parallel-moe-cp]
    phases' function, at gpt2_tiny (f32) over a one-rank gloo mesh:
    "pallas" through the gathered path and the MoE blocks on a ring of
    one, each held to the plain step; no kernel launched on the CPU; the
    collectives over cp the formula's (2 a layer on the gathered path,
    the MoE's 3 a layer)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import make_gpt2_train_step

    for cfg, plain, per_step in (
            (gpt2.gpt2_tiny(dtype=torch.float32, attention_impl="pallas"),
             gpt2.gpt2_tiny(dtype=torch.float32), 2 * 2 + 16 + 2),
            (gpt2.gpt2_tiny(dtype=torch.float32, attention_impl="ring",
                            moe_experts=4),
             gpt2.gpt2_tiny(dtype=torch.float32, moe_experts=4), 2 * 3 + 17 + 2)):
        run = smoke.mesh_against_plain("card", "parallel-gathered", "gpt2_tiny",
                                       gpt2, make_gpt2_train_step, cfg, 2, 2,
                                       world_one, device="cpu", plain_cfg=plain)
        assert run["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
        assert run["collectives"]["cp"] == 3 * per_step
        assert (f"collectives over cp: {3 * per_step} in 3 steps (the formula: "
                f"{3 * per_step})") in capsys.readouterr().out


def test_multi_card_gathered_and_moe_cp_ranks_over_gloo(smoke):
    """Two of the new multi-card plans' processes over gloo on the CPU, at
    gpt2_tiny: its MoE over cp 2 (the queue over (batch, cp)) held to its
    MoE at world 1 (the plan's "reference"), and "pallas" over cp 2 (the
    gathered path) held to the model at world 1, by hold_to_world_one:
    the same first loss on both ranks, near world 1's, the collectives
    over cp and tp of the formulas."""
    plan = dict(model="gpt2", config="gpt2_tiny", batch=2)
    moe = {"moe_experts": 4}
    one = smoke.run_ranks({**plan, "name": "test_w1", "mesh": {}}, 1,
                          backend="gloo", device="cpu")
    one_moe = smoke.run_ranks({**plan, "name": "test_moe_w1", "mesh": {},
                               "overrides": moe}, 1, backend="gloo", device="cpu")
    for p, ref in (({**plan, "name": "test_moe_cp2", "mesh": {"cp": 2},
                     "overrides": moe, "reference": "gpt2_moe8"}, one_moe[0]),
                   ({**plan, "name": "test_pallas_cp2", "mesh": {"cp": 2},
                     "overrides": {"attention_impl": "pallas"}}, one[0])):
        two = smoke.run_ranks(p, 2, backend="gloo", device="cpu")
        assert two[0]["first"]["loss"] == two[1]["first"]["loss"]
        smoke.hold_to_world_one("card", p, two, ref, device="cpu")


def test_bounds_count_only_the_kv_rows_a_call_needs(smoke):
    """Under a causal mask a call needs the kv rows up to its last query's
    position: the gathered path's first chunk reads a quarter of k and v
    at cp 4, a ring's future chunk none; the backward still writes dk and
    dv over every kv row."""
    assert smoke.kv_rows_needed(256, 1024, 0, 0, True) == 256
    assert smoke.kv_rows_needed(256, 1024, 768, 0, True) == 1024
    assert smoke.kv_rows_needed(256, 256, 0, 256, True) == 0
    assert smoke.kv_rows_needed(256, 1024, 0, 0, False) == 1024
    q = torch.empty(24, 12, 256, 64, device="meta")
    k = torch.empty(24, 12, 1024, 64, device="meta")
    _, _, fwd_bytes, _ = smoke.attention_bound(q, k, 0, 0, True)
    assert fwd_bytes == 2 * 24 * 12 * (2 * 256 + 2 * 256) * 64 + 4 * 24 * 12 * 256
    _, _, bwd_bytes, _ = smoke.attention_bwd_bound(q, k, 0, 0, True)
    assert bwd_bytes == 2 * 24 * 12 * (4 * 256 + 2 * 256 + 2 * 1024) * 64 + 4 * 24 * 12 * 256
    # the whole sequence: every row read, as before
    _, _, whole, _ = smoke.attention_bound(k, k, 0, 0, True)
    assert whole == 2 * 24 * 12 * 4 * 1024 * 64 + 4 * 24 * 12 * 1024


@pytest.fixture
def small_rllib(smoke, monkeypatch):
    """The [rllib-*] phases at a CPU size: 4 envs, short fragments, small
    batches, and a reward target a random CartPole policy meets."""
    monkeypatch.setattr(smoke, "RLLIB_NUM_ENVS", 4)
    monkeypatch.setattr(smoke, "RLLIB_PPO_FRAGMENT", 32)
    monkeypatch.setattr(smoke, "RLLIB_IMPALA_FRAGMENT", 16)
    monkeypatch.setattr(smoke, "RLLIB_PPO_TRAINING", dict(
        train_batch_size=256, minibatch_size=64, num_epochs=2, lr=3e-4))
    monkeypatch.setattr(smoke, "RLLIB_MA_TRAINING", dict(
        train_batch_size=128, minibatch_size=64, num_epochs=1))
    monkeypatch.setattr(smoke, "RLLIB_PONG_ITERS", 1)
    monkeypatch.setattr(smoke, "RLLIB_OFFPOLICY_ENVS", 4)
    monkeypatch.setattr(smoke, "RLLIB_DQN_FRAGMENT", 8)
    monkeypatch.setattr(smoke, "RLLIB_SAC_FRAGMENT", 8)
    monkeypatch.setattr(smoke, "RLLIB_BC_FRAGMENT", 16)
    monkeypatch.setattr(smoke, "RLLIB_DQN_TRAINING", dict(
        lr=1e-3, train_batch_size=32, learning_starts=32, target_update_freq=4,
        train_intensity=2, epsilon_timesteps=200))
    monkeypatch.setattr(smoke, "RLLIB_SAC_TRAINING", dict(
        lr=3e-3, train_batch_size=32, learning_starts=32, train_intensity=2))
    monkeypatch.setattr(smoke, "RLLIB_BC_TRAINING", dict(
        lr=3e-3, train_batch_size=32, train_intensity=2))
    monkeypatch.setattr(smoke, "RLLIB_BC_EXPERT_EPISODES", 2)
    monkeypatch.setattr(smoke, "RLLIB_PARITY_ROWS", 64)
    monkeypatch.setattr(smoke, "RLLIB_LOG_EVERY", 1)
    return smoke


def test_rllib_phases_on_the_cpu(small_rllib, capsys, monkeypatch):
    """Every [rllib-*] phase end to end with the learner on the CPU: the
    placement checks pass (learner tensors on the learner's device, the
    runner's policy on the CPU), the per-iteration rows are printed, the
    multi-agent result has the reference's keys, and the parity phase of
    one device against itself is exact."""
    smoke = small_rllib
    monkeypatch.setattr(smoke, "RLLIB_TARGET_REWARD", 12.0)
    monkeypatch.setattr(smoke, "RLLIB_BC_TARGET_REWARD", 12.0)
    monkeypatch.setattr(smoke, "RLLIB_MIN_EPISODES", 5)
    out = smoke.rllib_phase("card", device="cpu")
    assert out["rllib-ppo"]["env_steps"] == 256
    assert out["rllib-impala"]["cartpole_iterations"] >= 1
    for tag in ("rllib-dqn", "rllib-sac", "rllib-bc"):
        assert out[tag]["best"] >= 12.0 and out[tag]["updates"] >= 2, tag
        assert out[tag]["updates_per_s"] > 0 and out[tag]["sample_ms"] > 0, tag
    assert out["rllib-dqn"]["env_steps"] == 32 * out["rllib-dqn"]["iterations"]
    assert out["rllib-bc"]["env_steps"] == 0  # evaluation steps are not trained on
    assert out["rllib-bc"]["expert_mean_return"] == 500.0
    assert set(out["rllib-ma"]) == smoke.RLLIB_MA_KEYS
    assert set(out["rllib-parity"]) == {"ppo", "impala", "dqn", "sac", "bc"}
    assert all(v == {"grad_max_rel": 0.0, "param_max_abs": 0.0,
                     "metric_max_abs": 0.0}
               for v in out["rllib-parity"].values())
    text = capsys.readouterr().out
    for tag in ("rllib-ppo", "rllib-impala", "rllib-impala-pong", "rllib-dqn",
                "rllib-sac", "rllib-bc", "rllib-ma", "rllib-parity"):
        assert f"[{tag}]" in text
        assert f"[{tag}] phase took" in text or tag == "rllib-impala-pong"
    assert "minibatch steps" in text and "env_steps_per_sec" in text
    assert "[rllib-dqn] placement: learner 12 parameters, 12 targets, 24 moments on cpu" in text
    assert "[rllib-sac] placement: learner 37 parameters, 24 targets, 74 moments on cpu" in text
    assert re.search(r"\[rllib-parity\] dqn cpu vs cpu.*6 unreached.*params and "
                     r"targets.*td_errors \(128\)", text)


def test_rllib_phases_fail_where_they_should(small_rllib, monkeypatch):
    """A target not met within the step limit fails [rllib-ppo]; a learner
    on another device than the one asked for fails the placement check."""
    smoke = small_rllib
    monkeypatch.setattr(smoke, "RLLIB_TARGET_REWARD", 1e9)
    monkeypatch.setattr(smoke, "RLLIB_PPO_MAX_STEPS", 256)
    with pytest.raises(SystemExit, match=r"\[rllib-ppo\] episode_reward_mean"):
        smoke.rllib_ppo("card", device="cpu")
    from ray_tpu_torch.rllib.algorithms import PPOConfig

    algo = (PPOConfig().environment("CartPole-v1", num_envs_per_worker=2)
            .resources(learner_device="cpu").build())
    with pytest.raises(SystemExit, match="not cuda"):
        smoke.rllib_placement("rllib-ppo", algo, "cuda")
    monkeypatch.setattr(smoke, "RLLIB_DQN_MAX_ITERS", 2)
    with pytest.raises(SystemExit, match=r"\[rllib-dqn\] best episode_reward_mean"):
        smoke.rllib_dqn("card", device="cpu")
    from ray_tpu_torch.rllib.algorithms import SACConfig

    algo = (SACConfig().environment("CartPole-v1", num_envs_per_worker=2)
            .resources(learner_device="cpu").build())
    # a target left on another device than the learner's fails too
    algo.learner_group._learner.target["q2"]["pi"][0]["w"] = torch.zeros(
        4, 64, device="meta")
    with pytest.raises(SystemExit, match="not cpu"):
        smoke.rllib_placement("rllib-sac", algo, "cpu")


@pytest.mark.parametrize("algo", ["ppo", "impala", "dqn", "sac", "bc"])
def test_rllib_parity_fails_on_a_gradient_off_by_a_factor(small_rllib, monkeypatch,
                                                          capsys, algo):
    """A learner whose gradients are all 1.001 times the other's takes the
    same first Adam step (m/sqrt(v) is scale-free) yet fails [rllib-parity]:
    it holds every leaf's gradient, not only the parameters."""
    from ray_tpu_torch.rllib import learner as tlearner
    from ray_tpu_torch.rllib.algorithms import bc, dqn, sac

    cls = {"ppo": tlearner.PPOLearner, "impala": tlearner.IMPALALearner,
           "dqn": dqn.DQNLearner, "sac": sac.SACLearner, "bc": bc.BCLearner}[algo]
    made, loss_fn = [], cls.loss_fn

    def scaled(self, params, mb):
        loss, aux = loss_fn(self, params, mb)
        return (loss * 1.001 if self is made[-1] and len(made) == 2 else loss), aux
    init = cls.__init__

    def counting_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    monkeypatch.setattr(cls, "loss_fn", scaled)
    monkeypatch.setattr(cls, "__init__", counting_init)
    with pytest.raises(SystemExit, match=rf"\[rllib-parity\] {algo}: .*gradients"):
        small_rllib.rllib_parity(("cpu", "cpu"))
    row = re.search(rf"\[rllib-parity\] {algo} cpu vs cpu.*gradients max rel (\S+)",
                    capsys.readouterr().out)
    assert float(row.group(1)) > small_rllib.RLLIB_PARITY_GRAD_TOL


def test_rllib_parity_fails_on_a_dqn_target_that_aliases_the_parameters(
        small_rllib, monkeypatch, capsys):
    """The second device's DQN learner keeps its target as the live
    parameters (no copy): its second update bootstraps from the parameters
    after the first step, not from the initial target, and [rllib-parity]
    fails."""
    from ray_tpu_torch.rllib.algorithms import dqn

    made, init = [], dqn.DQNLearner.__init__

    def aliasing_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
        if len(made) == 2:
            self.target = self.params
    monkeypatch.setattr(dqn.DQNLearner, "__init__", aliasing_init)
    with pytest.raises(SystemExit, match=r"\[rllib-parity\] dqn: .*differ"):
        small_rllib.rllib_parity(("cpu", "cpu"))
    assert "[rllib-parity] sac" not in capsys.readouterr().out

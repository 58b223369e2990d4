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
import subprocess
import types

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

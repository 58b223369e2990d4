"""The checks of chip_smoke.py that run on the CPU too.

chip_smoke.py holds the backward kernel against `backward_scale_on_sums`,
the plain version with the kernel's rounding points, by mean error
(`MEAN_REL_TOL`). These tests show that this reference is the plain
version itself where the scale is a power of two (hd 64), and that at
hd 128, where the plain version rounds q * scale and k * scale to bf16
first, the check tells the two apart. They also drive the reader of the
SASS's highest register on cuobjdump-like text.
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
    model = smoke.backward_scale_on_sums(*args, causal=causal)
    plain = tattn.mha_backward_plain(*args, causal=causal)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_mean_error_check_separates_the_rounding_points_at_hd128(smoke, causal):
    q, k, v, o, lse, do = backward_inputs(1, 128)
    model = smoke.backward_scale_on_sums(q, k, v, o, lse, do, causal=causal)
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

"""The Hopper flash-attention kernels (ray_tpu_torch/ops/csrc/flash_fwd.cu
and flash_bwd.cu) against their plain PyTorch versions.

This file imports no JAX, so its on-card tests also run on a GPU machine
that has none:

    python -m pytest --noconftest -q -m cuda tests/test_torch_flash_kernel.py

Those tests are marked `cuda` and skip without a GPU. Tolerances (both
sides bf16 on the card): o at atol 2e-2 — o is rounded to bf16 (a step is
2**-7 near 1) and p is rounded against the running max in the kernel but
the row max in the plain version; lse at atol 1e-3 (f32, summation order
and the fast exp only). Backward: dq, dk and dv at 2e-2 of each
reference's max-abs — both round p and ds to bf16, but the kernel's p
comes from its own f32 logits (another summation order, the fast exp), so
a p or ds near a rounding edge falls one bf16 step (2**-8 relative) the
other way, and dq's bulk reduce-adds add in a run-dependent order. A gradient that
is 0 in exact arithmetic (S = 1: ds = p·(dp − delta) with dp = delta) is
held in absolute terms, against a max-abs of at least 1e-3.
"""

import pytest
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tattn

O_TOL = dict(atol=2e-2, rtol=0)
LSE_TOL = dict(atol=1e-3, rtol=0)
GRAD_REL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    before = (tattn.mha_forward_kernel.launches,
              tattn.mha_backward_kernel.launches)
    with pytest.raises(ValueError, match="not CUDA"):
        tattn.mha_forward_kernel(q, q, q)
    with pytest.raises(ValueError, match="not CUDA"):
        tattn.mha_backward_kernel(q, q, q, q, lse, q)
    assert (tattn.mha_forward_kernel.launches,
            tattn.mha_backward_kernel.launches) == before


def test_build_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _build.load(tattn.KERNEL)


def test_build_log_is_kept_beside_the_library(monkeypatch, tmp_path):
    """A library built by another process still has its ptxas report."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_logs", {})
    assert _build.build_log(tattn.KERNEL) == ""
    lib = _build._library_path(tattn.KERNEL)
    lib.with_suffix(".log").write_text("ptxas info    : Used 168 registers")
    assert "168 registers" in _build.build_log(tattn.KERNEL)


@pytest.mark.parametrize("kernel", [tattn.KERNEL, tattn.BWD_KERNEL])
def test_library_name_follows_source_and_flags(kernel):
    path = _build._library_path(kernel)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{kernel}-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("kernel", [tattn.KERNEL, tattn.BWD_KERNEL])
def test_library_name_follows_included_headers(kernel, monkeypatch, tmp_path):
    """A kernel's library name changes when a header its source includes
    changes, so a header edit never loads a stale library."""
    for src in (*_build.CSRC.glob("*.cuh"), _build.CSRC / f"{kernel}.cu"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    header = tmp_path / "hopper.cuh"
    assert '#include "hopper.cuh"' in (tmp_path / f"{kernel}.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._library_path(kernel)
    assert _build._library_path(kernel) == first
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._library_path(kernel) != first


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,hd,offsets", [
    (True, 1000, 64, (0, 0)),      # ragged tail
    (False, 256, 128, (0, 0)),
    (True, 256, 64, (128, 0)),     # q chunk after the kv chunk
    (True, 130, 64, (0, 32)),      # rows with no visible key
    (True, 1, 64, (0, 0)),
])
def test_kernel_matches_plain_on_card(cuda_device, causal, S, hd, offsets):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 3, S, hd, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    before = tattn.mha_forward_kernel.launches
    o, lse = tattn.mha_forward_kernel(q, k, v, *offsets, causal=causal)
    assert tattn.mha_forward_kernel.launches == before + 1
    ro, rl = tattn.mha_forward_plain(q, k, v, *offsets, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), **O_TOL)
    torch.testing.assert_close(lse, rl, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,H,Sq,Skv,hd,offsets", [
    (True, 2, 3, 65, 65, 64, (0, 0)),        # S not a multiple of 128
    (False, 2, 3, 127, 127, 64, (0, 0)),
    (True, 2, 3, 129, 129, 64, (0, 0)),
    (True, 2, 3, 1000, 1000, 64, (0, 0)),
    (False, 2, 3, 70, 300, 64, (0, 0)),      # Sq != Skv
    (True, 2, 3, 200, 300, 64, (100, 0)),    # q chunk partly in the future
    (True, 2, 3, 256, 192, 64, (0, 64)),     # first 64 rows see no key
    (True, 2, 3, 129, 129, 128, (0, 0)),     # hd 128, ragged
    (False, 2, 3, 1000, 1000, 128, (0, 0)),
    (True, 2, 3, 300, 500, 128, (200, 0)),
    (True, 1, 1, 256, 256, 64, (0, 0)),      # 2 work items: grid < SMs
    (True, 4, 12, 1024, 1024, 64, (0, 0)),   # 384 work items: > 1 per block
    (True, 4, 12, 640, 640, 128, (0, 0)),
])
def test_kernel_tiling_edges_match_plain_on_card(cuda_device, causal, B, H, Sq,
                                                 Skv, hd, offsets):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(B, H, Sq, hd, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B, H, Skv, hd, generator=g, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = tattn.mha_forward_kernel(q, k, v, *offsets, causal=causal)
    ro, rl = tattn.mha_forward_plain(q, k, v, *offsets, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), **O_TOL)
    torch.testing.assert_close(lse, rl, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_reads_no_row_of_the_next_head_on_card(cuda_device, causal):
    """Ragged S with B*H > 1 and v shifted by its own constant per (b, h): a
    tile that ran past S into the next head's rows would pull o toward that
    head's v. |v| stays below 1, where a bf16 step of o is at most 2**-8."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(2, 3, 129, 64, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    shift = 0.25 * (torch.arange(6, device=cuda_device) - 2.5).view(2, 3, 1, 1)
    v = (v.float() / 8 + shift).to(torch.bfloat16)
    o, lse = tattn.mha_forward_kernel(q, k, v, causal=causal)
    ro, rl = tattn.mha_forward_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), **O_TOL)
    torch.testing.assert_close(lse, rl, **LSE_TOL)


def rel_err(out, ref):
    scale = max(ref.float().abs().max().item(), 1e-3)
    return (out.float() - ref.float()).abs().max().item() / scale


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,hd,offsets", [
    (True, 256, 64, (0, 0)),
    (False, 256, 64, (0, 0)),
    (True, 1000, 64, (0, 0)),      # ragged tail
    (True, 256, 128, (0, 0)),
    (False, 200, 128, (0, 0)),     # ragged
    (True, 128, 64, (128, 0)),     # q chunk after the kv chunk
    (True, 64, 64, (0, 10_000)),   # kv chunk wholly in the future: all 0
    (True, 1, 64, (0, 0)),
])
def test_backward_kernel_matches_plain_on_card(cuda_device, causal, S, hd,
                                               offsets):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(2, 3, S, hd, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = tattn.mha_forward_kernel(q, k, v, *offsets, causal=causal)
    before = tattn.mha_backward_kernel.launches
    out = tattn.mha_backward_kernel(q, k, v, o, lse, do, *offsets, causal=causal)
    assert tattn.mha_backward_kernel.launches == before + 1
    ref = tattn.mha_backward_plain(q, k, v, o, lse, do, *offsets, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert rel_err(a, b) <= GRAD_REL, (name, rel_err(a, b))


@pytest.mark.cuda
def test_backward_offset_chunks_sum_to_the_full_backward(cuda_device):
    """q rows [128, 256) against kv chunks at 0 and 128 with the GLOBAL lse:
    dq summed and dk, dv stacked equal the full backward of those rows."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, do = (torch.randn(2, 3, 256, 64, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = tattn.mha_forward_kernel(q, k, v)
    do[:, :, :128] = 0
    full = tattn.mha_backward_kernel(q, k, v, o, lse, do)
    qh, oh, doh = (x[:, :, 128:].contiguous() for x in (q, o, do))
    lseh = lse[:, :, 128:].contiguous()
    parts = [tattn.mha_backward_kernel(
        qh, k[:, :, off:off + 128].contiguous(), v[:, :, off:off + 128].contiguous(),
        oh, lseh, doh, 128, off) for off in (0, 128)]
    torch.cuda.synchronize()
    dq = parts[0][0].float() + parts[1][0].float()
    assert rel_err(dq, full[0][:, :, 128:]) <= GRAD_REL
    for i in (1, 2):
        cat = torch.cat([parts[0][i], parts[1][i]], dim=2)
        assert rel_err(cat, full[i]) <= GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,H,Sq,Skv,hd,offsets", [
    (True, 2, 3, 65, 65, 64, (0, 0)),        # one q tile, one ragged kv tile
    (False, 2, 3, 127, 127, 64, (0, 0)),
    (True, 2, 3, 129, 129, 64, (0, 0)),      # a 1-row q tile and kv tile
    (False, 2, 3, 70, 300, 64, (0, 0)),      # Sq != Skv
    (True, 2, 3, 200, 300, 64, (100, 0)),    # q chunk partly in the future
    (True, 2, 3, 256, 192, 64, (0, 64)),     # first 64 rows see no key
    (True, 2, 3, 129, 129, 128, (0, 0)),     # hd 128, ragged
    (True, 2, 3, 300, 500, 128, (200, 0)),
    (True, 1, 1, 256, 256, 64, (0, 0)),      # 2 work items: grid < SMs
    (True, 4, 12, 1000, 1000, 64, (0, 0)),   # 384 work items, ragged S
    (False, 4, 12, 1000, 1000, 128, (0, 0)),
])
def test_backward_tiling_edges_match_plain_on_card(cuda_device, causal, B, H, Sq,
                                                   Skv, hd, offsets):
    """Ragged tiles, Sq != Skv, offsets, and a persistent grid with more
    (kv tile, head) work items than SMs."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, do = (torch.randn(B, H, Sq, hd, generator=g, device=cuda_device,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, H, Skv, hd, generator=g, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = tattn.mha_forward_kernel(q, k, v, *offsets, causal=causal)
    args = (q, k, v, o, lse, do, *offsets)
    out = tattn.mha_backward_kernel(*args, causal=causal)
    ref = tattn.mha_backward_plain(*args, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert rel_err(a, b) <= GRAD_REL, (name, rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,hd", [(True, 64), (False, 64), (True, 128)])
def test_backward_reads_no_row_of_the_next_head_on_card(cuda_device, causal, hd):
    """Ragged S with B*H > 1, and v and do shifted by their own constant per
    (b, h): a tile that ran past S into the next head's rows would pull dq,
    dk or dv toward that head's values."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, do = (torch.randn(2, 3, 200, hd, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    shift = 0.25 * (torch.arange(6, device=cuda_device) - 2.5).view(2, 3, 1, 1)
    v = (v.float() / 8 + shift).to(torch.bfloat16)
    do = (do.float() / 8 - shift).to(torch.bfloat16)
    o, lse = tattn.mha_forward_kernel(q, k, v, causal=causal)
    out = tattn.mha_backward_kernel(q, k, v, o, lse, do, causal=causal)
    ref = tattn.mha_backward_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert rel_err(a, b) <= GRAD_REL, (name, rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_backward_of_a_wholly_masked_kv_chunk_is_exactly_zero(cuda_device, hd):
    """A kv chunk wholly in the future of every q row: no q tile sees any kv
    tile, so dk = dv = 0 and dq = 0 exactly, from a finite global lse."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (torch.randn(2, 3, 300, hd, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = tattn.mha_forward_kernel(q, k, v)     # a finite lse
    dq, dk, dv = tattn.mha_backward_kernel(q, k, v, o, lse, do, 0, 10_000)
    torch.cuda.synchronize()
    assert torch.all(dq == 0) and torch.all(dk == 0) and torch.all(dv == 0)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 1, 16, 64, device=cuda_device)
    lse = torch.zeros(1, 1, 16, device=cuda_device)
    before = tattn.mha_backward_kernel.launches
    with pytest.raises(TypeError, match="bf16"):
        tattn.mha_forward_kernel(q, q, q)
    with pytest.raises(TypeError, match="bf16"):
        tattn.mha_backward_kernel(q, q, q, q, lse, q)
    q = torch.zeros(1, 1, 16, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.mha_forward_kernel(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.mha_backward_kernel(q, q, q, q, lse, q)
    assert tattn.mha_backward_kernel.launches == before


@pytest.mark.cuda
def test_gpt2_forward_on_card_goes_through_the_kernel(cuda_device):
    cfg = gpt2.gpt2_tiny(n_head=2)   # hd = 64
    params = gpt2.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                       device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len),
                           device=cuda_device)
    before = tattn.mha_forward_kernel.launches
    with torch.inference_mode():
        out = gpt2.forward(params, tokens, cfg)
        ref = gpt2.forward(params, tokens,
                           gpt2.gpt2_tiny(n_head=2, attention_impl="xla"))
    assert tattn.mha_forward_kernel.launches == before + cfg.n_layer
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-2, rtol=0)


@pytest.mark.cuda
def test_gpt2_train_step_on_card_goes_through_both_kernels(cuda_device):
    from ray_tpu_torch.train import train_step as ttrain

    cfg = gpt2.gpt2_tiny(n_head=2)   # hd = 64
    bundle = ttrain.make_gpt2_train_step(
        cfg, optimizer=ttrain.default_optimizer(lr=1e-3, warmup=1),
        device=cuda_device)
    batch = ttrain.synthetic_batch(cfg, 2, seed=0)
    before = (tattn.mha_forward_kernel.launches,
              tattn.mha_backward_kernel.launches)
    losses = [float(bundle.step_fn(bundle.state, batch)[1]["loss"])
              for _ in range(3)]
    assert (tattn.mha_forward_kernel.launches - before[0],
            tattn.mha_backward_kernel.launches - before[1]) == (6, 6)
    assert losses[-1] < losses[0]

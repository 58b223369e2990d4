#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # what the repository's check runs
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one request's and one training
                                       # step's device time by kernel
    python3 chip_smoke.py --compare-fwd OLD/flash_fwd.cu
                                       # also time another design of the
                                       # forward kernel against this one
    python3 chip_smoke.py --compare-bwd OLD/flash_bwd.cu
                                       # also time the first design of the
                                       # backward kernel (its older C entry
                                       # point) against this one

Phases, each fatal on failure (there is no CPU path and no caught phase):

1. Build every hand-written kernel from ops/csrc/ with nvcc (one process per
   source, all started together) and print ptxas' report per kernel:
   registers, static and dynamic shared memory, spills, and the highest
   register in the SASS (cuobjdump), which setmaxnreg may lift above the
   launch count. Any spill fails.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the edge cases, within the stated tolerances
   (the backward also, by mean error, against a version with its own
   rounding points), and time the kernel, the plain version and one
   PyTorch library call that computes the same function (a yardstick the
   port never calls) with CUDA events, the forward wrapper's host time per
   call, and the backward's C call alone (its three kernels, without the
   wrapper's checks and allocations). Print the bound: the larger of the
   bytes the function must move over 3.35 TB/s and its tensor-core
   operations over 989 TFLOP/s (H100 SXM data sheet, dense bf16).
3. The serving path: GPT-2-124M (full width, bf16, random weights from a
   seeded generator) in a Checkpoint, served by a TorchPredictor that
   answers 4 requests of 8 x 1024 tokens. Every launch count is set to 0
   just before and read just after; flash_fwd must have run exactly once
   per layer per request. The logits of one batch are checked against the
   same model with the plain attention path.
4. The training path: make_gpt2_train_step(gpt2_124m(), device="cuda") at
   B 24 x 1024 tokens (bench.py's first per-chip batch, remat off), one
   warm-up step, then 8 steps on one repeated synthetic batch. Every launch
   count is set to 0 just before and read just after; flash_fwd and
   flash_bwd must each have run exactly once per layer per step. Loss and
   grad norm must be finite and the loss must fall. Step time, tokens/s,
   peak device memory and the share of 989 TFLOP/s are printed. Then the
   loss and every parameter's gradient of one B 8 batch are checked against
   the same model with the plain attention path.
5. Print the kernels line, the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

# kernel vs plain version, both bf16 on the card: o is rounded to bf16 (one
# step is 2**-7 near 1) and p is rounded to bf16 against the running max in
# the kernel but against the row max in the plain version, so o may differ
# by a few bf16 steps; lse is f32 and differs only by summation order and
# the fast exp (relative ~1e-6, |lse| < 20).
O_TOL = 2e-2
LSE_TOL = 1e-3
# main path: flash kernel vs the plain "xla" attention path of the same
# model. That path rounds the logits to bf16 before the softmax (as the JAX
# model's does), which moves each probability by up to 2**-8 relative, so
# the two differ by more than the kernel does from its own plain version.
LOGITS_MAX_TOL = 0.125
LOGITS_MEAN_TOL = 1e-2
# backward kernel vs its plain version, both bf16 on the card, for dq, dk
# and dv, relative to each reference's max-abs: both round p and ds to
# bf16, but the kernel's p comes from its own f32 logits (another summation
# order, the fast exp), so an entry near a rounding edge falls one bf16
# step (2**-8 relative) the other way; dq is summed by bulk reduce-adds
# in a run-dependent order.
GRAD_REL_TOL = 2e-2
# backward kernel vs backward_scale_on_sums (the plain version with the
# kernel's rounding points), mean |difference| over mean |reference| per
# gradient: with the same rounding points only entries near a bf16 rounding
# edge fall the other way, a step each (measured on an H100: 2e-6 to 6e-6),
# while a moved rounding point or a small error anywhere in the sums moves
# most entries (the hd-128 kernel against the plain version, which rounds
# q * scale and k * scale to bf16: 2.7e-3 to 3.2e-3).
MEAN_REL_TOL = 1e-4
# training path, flash kernels vs the plain "xla" attention path of the
# same model and batch: the loss (about 11.0) and each parameter's
# gradient relative to its max-abs. The plain path rounds the logits to
# bf16 before the softmax, which moves each probability by up to 2**-8
# relative, and the two sum in other orders (measured on an H100: loss
# 5e-5 apart, worst gradient 7.6e-3 relative).
LOSS_TOL = 1e-3
GRAD_PATH_REL_TOL = 2e-2

N_REQUESTS, REQUEST_BATCH = 4, 8
TRAIN_BATCH, TRAIN_STEPS, COMPARE_BATCH = 24, 8, 8


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters`
    back-to-back calls (inputs warm in L2, as a layer's fresh q, k, v are)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_call_ms(fn, iters: int = 20) -> float:
    """Host time of one fn() call in ms, from the host clock around `iters`
    calls that are only enqueued (no synchronization): where it exceeds the
    device time, the card waits for the host."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t) / iters
    torch.cuda.synchronize()
    return host * 1e3


def visible_pairs(Sq, Skv, q_off, kv_off, causal) -> int:
    """(query, key) pairs this call's mask lets through: the work it needs."""
    if not causal:
        return Sq * Skv
    rows = q_off + torch.arange(Sq, dtype=torch.int64)
    return int((rows - kv_off + 1).clamp(0, Skv).sum())


def bound(nbytes: int, flops: int):
    """(bound ms, what bounds it, bytes, operations)."""
    t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations",
            nbytes, flops)


def attention_bound(q, k, q_off, kv_off, causal):
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    # q, k, v read once; o (bf16) and lse (f32) written once
    nbytes = 2 * B * H * (2 * Sq + 2 * Skv) * hd + 4 * B * H * Sq
    # s = q.k^T and o = p.v: 2 products of 2 * hd operations per pair
    flops = 4 * hd * B * H * visible_pairs(Sq, Skv, q_off, kv_off, causal)
    return bound(nbytes, flops)


def attention_bwd_bound(q, k, q_off, kv_off, causal):
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    # q, o, do, k, v (bf16) and lse (f32) read once; dq, dk, dv written once
    nbytes = 2 * B * H * (4 * Sq + 4 * Skv) * hd + 4 * B * H * Sq
    # s, dp, dv, dk, dq: 5 products of 2 * hd operations per visible pair
    flops = 10 * hd * B * H * visible_pairs(Sq, Skv, q_off, kv_off, causal)
    return bound(nbytes, flops)


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref| (at least 1e-3: a gradient that is 0
    in exact arithmetic is held in absolute terms)."""
    scale = max(ref.float().abs().max().item(), 1e-3)
    return (out.float() - ref.float()).abs().max().item() / scale


def mean_rel_err(out, ref) -> float:
    """mean |out - ref| over mean |ref|: small only if most entries agree."""
    scale = max(ref.float().abs().mean().item(), 1e-6)
    return (out.float() - ref.float()).abs().mean().item() / scale


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Phase 1: build
# --------------------------------------------------------------------------- #

def ptxas_report(log: str):
    """Per compiled entry function of a `-Xptxas -v` log: its template
    arguments, registers, static shared memory and spilled bytes."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            cur = dict(entry=m.group(1), template=args, registers=None,
                       smem_static=0, spill_stores=0, spill_loads=0)
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_static"] = int(m.group(1))
    return entries


def sass_highest_registers(lib: Path) -> dict:
    """Per entry function of a built library: the highest general register
    its SASS names (`R237`), from cuobjdump beside nvcc."""
    from ray_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    top, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            top[cur] = None
        elif cur is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                if top[cur] is None or int(r) > int(top[cur][1:]):
                    top[cur] = f"R{r}"
    return top


def build():
    from ray_tpu_torch.ops import _build, attention

    kernels = [attention.KERNEL, attention.BWD_KERNEL]
    t0 = time.perf_counter()
    _build.build_all(kernels)   # one nvcc per source, all started together
    log(f"[build] {', '.join(k + '.cu' for k in kernels)} built for sm_90a "
        f"in {time.perf_counter() - t0:.1f} s")
    smem_bytes = {name: getattr(_build.load(name), f"{name}_smem_bytes")
                  for name in kernels}
    spills = []
    for name in kernels:
        build_log = _build.build_log(name)
        if not ptxas_report(build_log):
            fail(f"no ptxas report for {name}.cu")
        top_reg = sass_highest_registers(_build._library_path(name))
        for line in build_log.splitlines():
            if "wgmma" in line or "warning" in line.lower():
                log(f"[build]   {name}: {line.strip()}")
        for e in ptxas_report(build_log):
            row = dict(kernel=name, template=e["template"],
                       registers=e["registers"], smem_static=e["smem_static"],
                       spill_stores=e["spill_stores"],
                       spill_loads=e["spill_loads"],
                       sass_highest_register=top_reg.get(e["entry"]))
            if f"{name}_kernelILi" in e["entry"]:   # the main kernel's <HD>
                row["smem_dynamic"] = smem_bytes[name](int(e["template"][0]))
            log(f"[build] {json.dumps(row)}")
            if e["spill_stores"] or e["spill_loads"]:
                spills.append(row)
    if spills:
        fail(f"ptxas spilled registers: {spills}")


# --------------------------------------------------------------------------- #
# Phase 2: kernel vs plain version
# --------------------------------------------------------------------------- #

def sdpa(q, k, v, causal):
    """SDPA's forward (the library yardstick; the port never calls it)."""
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)


def forward_case(name, q, k, v, q_off=0, kv_off=0, causal=True, library=None):
    """flash_fwd against mha_forward_plain on the same inputs, timed; fails
    outside O_TOL / LSE_TOL. Returns (row, o, lse) of the kernel."""
    from ray_tpu_torch.ops import attention as A

    o, lse = A.mha_forward_kernel(q, k, v, q_off, kv_off, causal=causal)
    po, plse = A.mha_forward_plain(q, k, v, q_off, kv_off, causal=causal)
    torch.cuda.synchronize()
    o_err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    del po, plse
    ms = cuda_ms(lambda: A.mha_forward_kernel(q, k, v, q_off, kv_off,
                                              causal=causal))
    host_ms = host_call_ms(lambda: A.mha_forward_kernel(q, k, v, q_off, kv_off,
                                                        causal=causal))
    plain_ms = cuda_ms(lambda: A.mha_forward_plain(q, k, v, q_off, kv_off,
                                                   causal=causal), iters=5)
    library_ms = cuda_ms(library) if library else None
    bound_ms, bound_by, nbytes, flops = attention_bound(q, k, q_off, kv_off,
                                                        causal)
    row = dict(case=name, shape=list(q.shape), skv=k.shape[2], q_off=q_off,
               kv_off=kv_off, causal=causal, o_err=o_err, lse_err=lse_err,
               max_abs_err=max(o_err, lse_err),
               ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, bound_share=bound_ms / ms)
    log(f"[kernel] {json.dumps(row)}")
    if not (o_err <= O_TOL and lse_err <= LSE_TOL):
        fail(f"flash_fwd case {name}: |o| err {o_err} (tol {O_TOL}), "
             f"|lse| err {lse_err} (tol {LSE_TOL})")
    return row, o, lse


def attention_cases(gen):
    def rand(B, H, S, hd):
        return [torch.randn(B, H, S, hd, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(3)]

    check = forward_case
    rows = {}
    q, k, v = rand(8, 12, 1024, 64)
    rows["main"], full_o, _ = check("causal B8 H12 S1024 hd64", q, k, v,
                                    library=sdpa(q, k, v, True))
    rows["full"], _, _ = check("non-causal B8 H12 S1024 hd64", q, k, v,
                               causal=False, library=sdpa(q, k, v, False))
    qr, kr, vr = (x[:, :, :1000].contiguous() for x in (q, k, v))
    rows["ragged"], _, _ = check("ragged causal S1000", qr, kr, vr,
                                 library=sdpa(qr, kr, vr, True))

    # the second half of the queries against kv chunks at 0 and 512, merged
    # by lse, must give the second half of full causal attention
    qh = q[:, :, 512:].contiguous()
    parts = []
    for off in (0, 512):
        kc, vc = (x[:, :, off:off + 512].contiguous() for x in (k, v))
        row, o, lse = check(f"q@512 vs kv@{off}", qh, kc, vc, 512, off)
        rows[f"offsets{off}"] = row
        parts.append((o.float(), lse))
    (oa, la), (ob, lb) = parts
    m = torch.maximum(la, lb)
    wa, wb = torch.exp(la - m)[..., None], torch.exp(lb - m)[..., None]
    merged = (oa * wa + ob * wb) / (wa + wb)
    merge_err = (merged - full_o[:, :, 512:].float()).abs().max().item()
    log(f"[kernel] merged-by-lse vs full causal: max |err| {merge_err}")
    if not merge_err <= O_TOL:
        fail(f"lse merge differs from full attention by {merge_err}")

    row, o, lse = check("fully masked kv@10000", qh, kc, vc, 0, 10_000)
    rows["masked"] = row
    if not (torch.all(o == 0) and torch.all(lse == -1e30)):
        fail("fully masked chunk: o must be 0 and lse -1e30 everywhere")

    q8, k8, v8 = rand(8, 12, 1024, 128)
    rows["hd128"], _, _ = check("causal B8 H12 S1024 hd128", q8, k8, v8,
                                library=sdpa(q8, k8, v8, True))
    return rows


def compare_forward(src: str, gen):
    """Time the flash_fwd built from another source `src` (with the same C
    entry point, e.g. an earlier design unpacked from git history) against
    the one in ops/csrc/, in turns old, new, new, old, at the main paths'
    shapes; both are first held against the plain version."""
    from ray_tpu_torch.ops import _build, attention as A

    out = _build.BUILD_DIR / "libflash_fwd_compare.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = A._entry(ctypes.CDLL(str(out)), "flash_fwd_bf16", 5)

    def old(q, k, v):
        o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
        B, H, S, hd = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, H, S, S, hd, 0, 0, hd ** -0.5, 1,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_fwd_bf16 (compared source)")
        return o, lse

    def new(q, k, v):
        return A.mha_forward_kernel(q, k, v)

    for B, hd in ((TRAIN_BATCH, 64), (REQUEST_BATCH, 64), (REQUEST_BATCH, 128)):
        q, k, v = (torch.randn(B, 12, 1024, hd, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        po, plse = A.mha_forward_plain(q, k, v)
        errs = {}
        for name, f in (("old", old), ("new", new)):
            o, lse = f(q, k, v)
            torch.cuda.synchronize()
            errs[name] = max((o.float() - po.float()).abs().max().item(),
                             (lse - plse).abs().max().item())
        ms = [cuda_ms(lambda f=f: f(q, k, v)) for f in (old, new, new, old)]
        row = dict(shape=[B, 12, 1024, hd], src=src, max_abs_err=errs,
                   old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]],
                   speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]))
        log(f"[compare] {json.dumps(row)}")
        if not all(e <= O_TOL for e in errs.values()):
            fail(f"compared forward kernels disagree with the plain version: "
                 f"{errs}")


def sdpa_backward(q, k, v, do, causal):
    """SDPA's flash backward alone, on SDPA's own saved outputs (the
    library yardstick; the port never calls it)."""
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset, _ = (
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal))
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)


def backward_scale_on_sums(q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True):
    """mha_backward_plain with the kernel's rounding points: the scale,
    rounded to bf16, multiplies the f32 sums q.k^T, ds^T.q and ds.k rather
    than q and k before the products. The same function as the plain
    version where the scale is a power of two (hd 64); at hd 128 the one the
    kernel computes."""
    from ray_tpu_torch.ops import attention as A

    Sq, Skv, hd = q.shape[2], k.shape[2], q.shape[3]
    sc = float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    qf, kf, dof = q.float(), k.float(), do.float()
    p = torch.exp(qf @ kf.transpose(-1, -2) * sc - lse[..., None])
    if causal:
        rows = q_off + torch.arange(Sq, device=q.device)[:, None]
        cols = kv_off + torch.arange(Skv, device=q.device)[None, :]
        p = p.masked_fill(rows < cols, 0.0)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = (p * (dp - A._delta(o, do)[..., None])).to(q.dtype).float()
    dk = ds.transpose(-1, -2) @ qf * sc
    dq = ds @ kf * sc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_call(q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True):
    """The backward's C call alone, on outputs and scratch allocated once:
    its three kernels (prologue, main kernel, dq's cast) without the
    wrapper's checks and allocations."""
    from ray_tpu_torch.ops import _build, attention as A

    B, H, Sq, hd = q.shape
    lib = _build.load(A.BWD_KERNEL)
    scratch = torch.empty(A._scratch_bytes(lib)(B * H, Sq, hd) // 4,
                          dtype=torch.float32, device="cuda")
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    fn = A._entry(lib, "flash_bwd_bf16", 10)
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, *outs, scratch)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(*ptrs, B, H, Sq, k.shape[2], hd, q_off, kv_off,
                        hd ** -0.5, int(causal), stream), "flash_bwd_bf16")
        return outs
    return call


def compare_backward(src: str, gen):
    """Time the flash_bwd built from another source `src` with the first
    design's C entry point (delta and a zeroed f32 dq from the caller; e.g.
    that design unpacked from git history) against the one in ops/csrc/, in
    turns old, new, new, old, at the training and serving shapes and at
    hd 128. The old one is called as its wrapper called it: delta in
    PyTorch, dq zeroed, cast after. Both are first held against the plain
    version, and SDPA's flash backward is timed beside them."""
    from ray_tpu_torch.ops import _build, attention as A

    out = _build.BUILD_DIR / "libflash_bwd_compare.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                           check=True, capture_output=True, text=True, timeout=600)
    spills = sum(e["spill_stores"] + e["spill_loads"]
                 for e in ptxas_report(built.stdout + built.stderr))
    old, new = _caller_delta_entry_call(ctypes.CDLL(str(out))), A.mha_backward_kernel

    for B, hd in ((TRAIN_BATCH, 64), (REQUEST_BATCH, 64), (REQUEST_BATCH, 128)):
        q, k, v, do = (torch.randn(B, 12, 1024, hd, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = A.mha_forward_kernel(q, k, v)
        args = (q, k, v, o, lse, do)
        ref = A.mha_backward_plain(*args)
        errs = {}
        for name, f in (("old", old), ("new", new)):
            got = f(*args)
            torch.cuda.synchronize()
            errs[name] = {n: rel_err(a, b)
                          for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        del ref
        ms = [cuda_ms(lambda f=f: f(*args)) for f in (old, new, new, old)]
        row = dict(shape=[B, 12, 1024, hd], src=src, spill_bytes=spills,
                   rel_err=errs, old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]],
                   speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]),
                   sdpa_backward_ms=cuda_ms(sdpa_backward(q, k, v, do, True)))
        log(f"[compare-bwd] {json.dumps(row)}")
        if not all(e <= GRAD_REL_TOL for d in errs.values() for e in d.values()):
            fail(f"compared backward kernels disagree with the plain version: "
                 f"{errs}")


def _caller_delta_entry_call(lib):
    """A source with the first design's C entry point, called as its wrapper
    called it: delta in PyTorch, dq zeroed in f32, cast after."""
    from ray_tpu_torch.ops import _build, attention as A

    fn = A._entry(lib, "flash_bwd_bf16", 9)

    def call(q, k, v, o, lse, do):
        delta = A._delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        B, H, S, hd = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, S, S, hd, 0, 0, hd ** -0.5, 1,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_bwd_bf16 (compared source)")
        return dq.to(q.dtype), dk, dv
    return call


def backward_cases(gen):
    from ray_tpu_torch.ops import attention as A

    def rand(B, H, S, hd):
        return [torch.randn(B, H, S, hd, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(4)]

    def check(name, q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True,
              library=None):
        args = (q, k, v, o, lse, do, q_off, kv_off)
        out = A.mha_backward_kernel(*args, causal=causal)
        ref = A.mha_backward_plain(*args, causal=causal)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), out, ref)}
        max_abs = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(out, ref))
        model = backward_scale_on_sums(*args, causal=causal)
        mean_errs = {ref_name: {n: mean_rel_err(a, b)
                                for n, a, b in zip(("dq", "dk", "dv"), out, r)}
                     for ref_name, r in (("model", model), ("plain", ref))}
        del model, ref
        ms = cuda_ms(lambda: A.mha_backward_kernel(*args, causal=causal))
        kernel_ms = cuda_ms(backward_call(*args, causal=causal))
        plain_ms = cuda_ms(lambda: A.mha_backward_plain(*args, causal=causal),
                           iters=3, warmup=1)
        library_ms = cuda_ms(library) if library else None
        bound_ms, bound_by, nbytes, flops = attention_bwd_bound(
            q, k, q_off, kv_off, causal)
        row = dict(case=name, shape=list(q.shape), skv=k.shape[2], q_off=q_off,
                   kv_off=kv_off, causal=causal, rel_err=errs,
                   mean_rel_err=mean_errs, max_abs_err=max_abs,
                   ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library="sdpa flash backward alone" if library else None,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, bound_share=bound_ms / ms)
        log(f"[kernel-bwd] {json.dumps(row)}")
        if not all(e <= GRAD_REL_TOL for e in errs.values()):
            fail(f"flash_bwd case {name}: relative errors {errs} "
                 f"(tol {GRAD_REL_TOL})")
        if not all(e <= MEAN_REL_TOL for e in mean_errs["model"].values()):
            fail(f"flash_bwd case {name}: mean relative errors against its "
                 f"rounding points {mean_errs['model']} (tol {MEAN_REL_TOL})")
        return row, out

    def forward(q, k, v, causal=True):
        return A.mha_forward_kernel(q, k, v, causal=causal)

    rows = {}
    q, k, v, do = rand(TRAIN_BATCH, 12, 1024, 64)
    # the training path's forward at its own shape, held and timed like the
    # serving shape's; its o and lse feed the backward cases
    rows["fwd_main"], o, lse = forward_case(
        f"causal B{TRAIN_BATCH} H12 S1024 hd64 (training shape)", q, k, v,
        library=sdpa(q, k, v, True))
    rows["main"], full = check(
        f"causal B{TRAIN_BATCH} H12 S1024 hd64 (training shape)",
        q, k, v, o, lse, do, library=sdpa_backward(q, k, v, do, True))
    on, lsen = forward(q, k, v, causal=False)
    rows["full"], _ = check("non-causal", q, k, v, on, lsen, do, causal=False,
                            library=sdpa_backward(q, k, v, do, False))
    qr, kr, vr, dr = (x[:, :, :1000].contiguous() for x in (q, k, v, do))
    orr, lser = forward(qr, kr, vr)
    rows["ragged"], _ = check("ragged causal S1000", qr, kr, vr, orr, lser, dr,
                              library=sdpa_backward(qr, kr, vr, dr, True))

    # q rows [512, 1024) against kv chunks at 0 and 512 with the GLOBAL lse:
    # dq summed and dk, dv stacked equal the full backward of those rows
    d_tail = do.clone()
    d_tail[:, :, :512] = 0
    _, tail = check("full, do of rows < 512 zeroed", q, k, v, o, lse, d_tail)
    qh, oh, dh = (x[:, :, 512:].contiguous() for x in (q, o, do))
    lseh = lse[:, :, 512:].contiguous()
    parts = []
    for off in (0, 512):
        kc, vc = (x[:, :, off:off + 512].contiguous() for x in (k, v))
        row, out = check(f"q@512 vs kv@{off}, global lse", qh, kc, vc, oh, lseh,
                         dh, 512, off)
        rows[f"offsets{off}"] = row
        parts.append(out)
    sums = {"dq": rel_err(parts[0][0].float() + parts[1][0].float(),
                          tail[0][:, :, 512:]),
            "dk": rel_err(torch.cat([parts[0][1], parts[1][1]], 2), tail[1]),
            "dv": rel_err(torch.cat([parts[0][2], parts[1][2]], 2), tail[2])}
    log(f"[kernel-bwd] offset chunks summed vs full backward: {json.dumps(sums)}")
    if not all(e <= GRAD_REL_TOL for e in sums.values()):
        fail(f"offset chunks do not sum to the full backward: {sums}")

    q8, k8, v8, d8 = rand(8, 12, 1024, 128)
    o8, lse8 = forward(q8, k8, v8)
    rows["hd128"], _ = check("causal B8 H12 S1024 hd128", q8, k8, v8, o8, lse8,
                             d8, library=sdpa_backward(q8, k8, v8, d8, True))
    return rows


# --------------------------------------------------------------------------- #
# Phase 3: the main path
# --------------------------------------------------------------------------- #

def main_path(card: str, profile: bool):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train.batch_predictor import TorchPredictor
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.train_step import synthetic_batch

    cfg = gpt2.gpt2_124m()
    t0 = time.perf_counter()
    params = gpt2.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    log(f"[model] gpt2_124m: {gpt2.param_count(cfg)} params, L={cfg.n_layer} "
        f"D={cfg.d_model} H={cfg.n_head} S={cfg.seq_len} "
        f"vocab={cfg.padded_vocab}, {cfg.dtype}; init "
        f"{time.perf_counter() - t0:.2f} s")

    def apply_fn(params, batch):
        logits = gpt2.forward(params, batch["tokens"], cfg)[:, -1, :cfg.vocab_size]
        best = logits.float().max(dim=-1)
        return {"next_token": best.indices, "logit": best.values}

    predictor = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), apply_fn=apply_fn,
        device="cuda")
    requests = [synthetic_batch(cfg, REQUEST_BATCH, seed=i)["tokens"]
                for i in range(N_REQUESTS)]

    torch.cuda.synchronize()
    A.mha_forward_kernel.launches = 0
    A.mha_backward_kernel.launches = 0
    answers, times = [], []
    for tokens in requests:
        t = time.perf_counter()
        answers.append(predictor.predict({"tokens": tokens}))  # numpy: synced
        times.append(time.perf_counter() - t)
    launches = A.mha_forward_kernel.launches

    expected = cfg.n_layer * N_REQUESTS
    log(f"[main] flash_fwd launches: {launches} (expected {expected}), "
        f"flash_bwd {A.mha_backward_kernel.launches} (expected 0)")
    if launches != expected or A.mha_backward_kernel.launches:
        fail(f"serving path launched flash_fwd {launches} times (expected "
             f"{expected}) and flash_bwd {A.mha_backward_kernel.launches} "
             f"(expected 0)")
    for ans in answers:
        tok, logit = ans["next_token"], ans["logit"]
        if tok.shape != (REQUEST_BATCH,) or not (
                (tok >= 0).all() and (tok < cfg.vocab_size).all()):
            fail(f"predictions out of range: {tok}")
        if not all(map(math.isfinite, logit.tolist())):
            fail(f"non-finite logits: {logit}")
    tokens_per_request = REQUEST_BATCH * cfg.seq_len
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log("[main] " + json.dumps(dict(
        card=card, requests=N_REQUESTS, batch=REQUEST_BATCH, seq_len=cfg.seq_len,
        request_ms=[t * 1e3 for t in times], median_after_first_ms=steady * 1e3,
        tokens_per_s=tokens_per_request / steady,
        next_tokens=answers[0]["next_token"].tolist(),
    )))

    # the same weights and batch through the plain attention path
    toks = torch.as_tensor(requests[0], device="cuda")
    plain_cfg = replace(cfg, attention_impl="xla")
    with torch.inference_mode():
        lk = gpt2.forward(params, toks, cfg).float()
        lp = gpt2.forward(params, toks, plain_cfg).float()
    diff = (lk - lp).abs()
    agree = (lk[:, :, :cfg.vocab_size].argmax(-1)
             == lp[:, :, :cfg.vocab_size].argmax(-1)).float().mean().item()
    log(f"[main] logits vs plain attention path: max |err| "
        f"{diff.max().item()} (tol {LOGITS_MAX_TOL}), mean |err| "
        f"{diff.mean().item()} (tol {LOGITS_MEAN_TOL}), |logits| max "
        f"{lp.abs().max().item()}, argmax agreement {agree}")
    if not (torch.isfinite(lk).all() and diff.max().item() <= LOGITS_MAX_TOL
            and diff.mean().item() <= LOGITS_MEAN_TOL):
        fail("main-path logits disagree with the plain attention path")

    if profile:
        profile_device_time("one request",
                            lambda: predictor.predict({"tokens": requests[0]}))
    return launches


_CATEGORIES = (        # kernel name fragment -> category, first match wins
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_bwd", "flash_bwd (prologue, main kernel, dq cast)"),
    ("nvjet", "matrix products (cuBLAS)"), ("gemm", "matrix products (cuBLAS)"),
    ("reduce_kernel", "reductions"), ("copy", "copies and casts"),
    ("elementwise", "other elementwise"),
)


def profile_device_time(what: str, fn, top: int = 12):
    """Device time of one call of fn by kernel name and by category
    (torch.profiler); fn ends in a synchronization."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
    # kernels only: an operator's row repeats the device time of its
    # kernels, and a user annotation (Optimizer.step) spans kernels too
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    total = sum(e.self_device_time_total for e in events)
    log(f"[profile] {what}: wall {wall * 1e3:.3f} ms, device busy "
        f"{total / 1e3:.3f} ms ({100 * total / 1e6 / wall:.1f}% of wall)")
    by_category = {}
    for e in events:
        name = e.key.lower()
        cat = next((c for frag, c in _CATEGORIES if frag in name), "other")
        by_category[cat] = by_category.get(cat, 0) + e.self_device_time_total
    for cat, us in sorted(by_category.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {us / 1e3:9.3f} ms {100 * us / max(total, 1):5.1f}% "
            f"{cat}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")


# --------------------------------------------------------------------------- #
# Phase 4: the training path
# --------------------------------------------------------------------------- #

def train_path(card: str, profile: bool):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train.train_step import (
        default_optimizer, make_gpt2_train_step, named_leaves, param_leaves,
        synthetic_batch,
    )

    cfg = gpt2.gpt2_124m(remat=False)
    t0 = time.perf_counter()
    bundle = make_gpt2_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")   # device-resident batch
             for k, v in synthetic_batch(cfg, TRAIN_BATCH, seed=0).items()}
    state = bundle.state
    state, _ = bundle.step_fn(state, batch)         # warm-up step
    torch.cuda.synchronize()
    log(f"[train] gpt2_124m B={TRAIN_BATCH} S={cfg.seq_len} remat=False; init "
        f"and warm-up step {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    A.mha_forward_kernel.launches = 0
    A.mha_backward_kernel.launches = 0
    metrics, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = bundle.step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(m)
    launches = {"flash_fwd": A.mha_forward_kernel.launches,
                "flash_bwd": A.mha_backward_kernel.launches}
    peak = torch.cuda.max_memory_allocated()

    expected = cfg.n_layer * TRAIN_STEPS
    log(f"[train] launches: {json.dumps(launches)} (expected {expected} each)")
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"training path launched {launches}, expected {expected} each")
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    if not all(map(math.isfinite, losses + norms)):
        fail(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    tokens = TRAIN_BATCH * cfg.seq_len
    step_s = sorted(times)[len(times) // 2]
    tokens_per_s = tokens / step_s
    log("[train] " + json.dumps(dict(
        card=card, batch=TRAIN_BATCH, seq_len=cfg.seq_len, steps=TRAIN_STEPS,
        loss=losses, grad_norm=norms, step_ms=[t * 1e3 for t in times],
        step_ms_median=step_s * 1e3, tokens_per_s=tokens_per_s,
        peak_memory_bytes=peak, flops_per_token=gpt2.flops_per_token(cfg),
        share_of_989_tflops=gpt2.flops_per_token(cfg) * tokens_per_s
        / PEAK_BF16_FLOPS,
    )))
    if profile:
        def one_step():
            bundle.step_fn(state, batch)
            torch.cuda.synchronize()
        profile_device_time("one training step", one_step, top=16)

    # one batch's loss and gradients, flash kernels vs the plain path
    small = synthetic_batch(cfg, COMPARE_BATCH, seed=1)
    leaves = param_leaves(state["params"])
    results = []
    for impl_cfg in (cfg, replace(cfg, attention_impl="xla")):
        loss = gpt2.loss_fn(state["params"], small["tokens"], small["targets"],
                            impl_cfg)
        results.append((loss.item(), torch.autograd.grad(loss, leaves)))
    (lk, gk), (lp, gp) = results
    by_leaf = {name: rel_err(a, b) for (name, _), a, b in
               zip(named_leaves(state["params"]), gk, gp)}
    worst = max(by_leaf, key=by_leaf.get)
    log(f"[train] B{COMPARE_BATCH} loss flash {lk} vs plain {lp} (tol "
        f"{LOSS_TOL}); gradient relative errors {json.dumps(by_leaf)}, worst "
        f"{worst} {by_leaf[worst]} (tol {GRAD_PATH_REL_TOL})")
    if not (abs(lk - lp) <= LOSS_TOL and by_leaf[worst] <= GRAD_PATH_REL_TOL):
        fail("training-path loss or gradients disagree with the plain "
             "attention path")
    return launches


# --------------------------------------------------------------------------- #

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--compare-fwd", metavar="SRC",
                        help="also time flash_fwd built from SRC (same C "
                             "entry point) against the current one")
    parser.add_argument("--compare-bwd", metavar="SRC",
                        help="also time flash_bwd built from SRC (the first "
                             "design's C entry point) against the current one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}")

    card = nvidia_smi()
    log(f"[env] {card}")
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd = attention_cases(gen)
    if args.compare_fwd:
        compare_forward(args.compare_fwd, gen)
    bwd = backward_cases(gen)
    if args.compare_bwd:
        compare_backward(args.compare_bwd, gen)
    serve_launches = main_path(card, args.profile)
    train_launches = train_path(card, args.profile)

    def numbers(row, launches):
        """One path's numbers for a kernel: its launches on that path beside
        the case run at that path's shape."""
        return {"launches": launches, "shape": row["shape"],
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "bound_share",
                                       "library_ms")}}

    # top level: the training path (the newest main path) at its own shape;
    # by_path: each main path at its own shape with its own launches
    fwd_paths = {"train": numbers(bwd["fwd_main"], train_launches["flash_fwd"]),
                 "serve": numbers(fwd["main"], serve_launches)}
    bwd_paths = {"train": numbers(bwd["main"], train_launches["flash_bwd"])}
    log(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:64",
        "status": "ported", **fwd_paths["train"], "by_path": fwd_paths,
    }, {
        "name": "flash_bwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/attention.py:220",
        "status": "ported", **bwd_paths["train"], "by_path": bwd_paths,
    }], "to_port": []}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

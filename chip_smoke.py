#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # what the repository's check runs
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one request's and one training
                                       # step's device time by kernel, on
                                       # every model path
    python3 chip_smoke.py --compare-fwd OLD/flash_fwd.cu
    python3 chip_smoke.py --compare-bwd OLD/flash_bwd.cu
                                       # also time another design of a
                                       # kernel (same C entry point, e.g.
                                       # an earlier one from git history)
                                       # against this one

Phases, each fatal on failure (there is no CPU path and no caught phase):

1. Build every hand-written kernel from ops/csrc/ with nvcc (one process per
   source, all started together) and print ptxas' report per kernel:
   registers, static and dynamic shared memory, spills, and the highest
   register in the SASS (cuobjdump), which setmaxnreg may lift above the
   launch count. Any spill fails.
2. Hold each kernel against its plain PyTorch version on the card, at every
   model path's shapes and at the edge cases, within the stated tolerances
   (the backward also by mean error, which a moved rounding point fails),
   and time the kernel, the plain version and one PyTorch library call that
   computes the same function (a yardstick the port never calls) with CUDA
   events, the forward wrapper's host time per call, and the backward's C
   call alone (its three kernels, without the wrapper's checks and
   allocations). Print the bound: the larger of the bytes the function
   must move over 3.35 TB/s and its tensor-core operations over 989 TFLOP/s
   (H100 SXM data sheet, dense bf16).
3. GPT-2 serving: GPT-2-124M (full width, bf16, random weights from a
   seeded generator) in a Checkpoint, served by a TorchPredictor that
   answers 4 requests of 8 x 1024 tokens. Every launch count is set to 0
   just before and read just after; flash_fwd must have run exactly once
   per layer per request. The logits of one batch are checked against the
   same model with the plain attention path.
4. GPT-2 training: make_gpt2_train_step(gpt2_124m(), device="cuda") at
   B 24 x 1024 tokens (bench.py's first per-chip batch, remat off), one
   warm-up step, then 8 steps on one repeated synthetic batch. Every launch
   count is set to 0 just before and read just after; flash_fwd and
   flash_bwd must each have run exactly once per layer per step. Loss and
   grad norm must be finite and the loss must fall. Step time, tokens/s,
   peak device memory and the share of 989 TFLOP/s are printed. Then the
   loss and every parameter's gradient of one B 8 batch are checked against
   the same model with the plain attention path.
5. Llama serving: llama_7b at full depth and width (L 32, D 4096, H 32,
   hd 128, S 4096; 27 GB of f32 weights), as phase 3, 4 requests of
   2 x 4096 tokens: 32 flash_fwd launches a request.
6. Llama training: make_llama_train_step(llama_1b()) at full depth and
   width (L 22, D 2048, H 32 over 8 kv heads, hd 64, S 2048), as phase 4,
   at B 8 x 2048 tokens; its gradients are checked on one sequence.
7. The hd-128 backward inside a model: llama_7b at full width and S 4096,
   cut to 2 layers, one sequence; loss and every gradient, flash kernels
   against the plain attention path.
8. [moe] The MoE layer at GPT-2-124M's width (D 768, F 3072, E 8, top-2,
   8 x 1024 tokens), bf16 and f32, capacity factors 1.25 and 0.5 (drops):
   `moe_mlp` (index dispatch, the model path's) against `moe_mlp_plain`
   (the reference's dense einsums): identical routing, y, aux and every
   gradient within the stated tolerances, two calls bitwise equal; both
   timed, forward and forward + backward.
9. [moe-serve] gpt2_124m(moe_experts=8) at full width and depth (521 M
   params), as phase 3: 12 flash_fwd launches a request. The logits are
   checked against the plain attention path within limits measured on the
   card, and the routing decisions that differ between the two paths
   (discrete choices that bf16 noise can flip) are counted and bounded.
10. [moe-train] The same model as phase 4 at B 24 x 1024: 12 launches of
   each kernel a step, finite and falling loss; the share of 989 TFLOP/s
   from the work the card executes (E x C capacity slots per T tokens)
   printed beside the JAX formula's (which counts every expert for every
   token); gradients of one B 8 batch against the plain attention path,
   with the differing routing decisions counted.
   Each model path starts with the device memory the last one used freed,
   so that the peak memory it prints is its own.
11. Print the kernels line (each kernel's numbers by model path), the card's
   name and power limit, and last the result line {"ok": true, ...}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import re
import subprocess
import sys
import time
from contextlib import contextmanager
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
# backward kernel vs its plain version (which rounds where the TPU kernel
# rounds), mean |difference| over mean |reference| per gradient: with the
# same rounding points only entries near a bf16 rounding edge fall the other
# way, a step each (measured on an H100: 2e-6 to 6e-6), while a moved
# rounding point or a small error anywhere in the sums moves most entries
# (the scale applied to f32 sums instead of to q and k at hd 128: 2.7e-3 to
# 3.2e-3).
MEAN_REL_TOL = 1e-4
# training path, flash kernels vs the plain "xla" attention path of the
# same model and batch: the loss (about 11.0) and each parameter's
# gradient relative to its max-abs. The plain path rounds the logits to
# bf16 before the softmax, which moves each probability by up to 2**-8
# relative, and the two sum in other orders (measured on an H100: loss
# 5e-5 apart, worst gradient 7.6e-3 relative).
LOSS_TOL = 1e-3
GRAD_PATH_REL_TOL = 2e-2
# the Llama paths against their plain "xla" path: llama_7b is 32 bf16
# layers at S 4096 whose attention logits reach about 8 (GPT-2-124M's stay
# near 1), where the plain path's bf16 rounding of the logits is a step of
# up to 2**-4 and moves a probability by up to 3 % relative. The smoke
# prints each path's distance from attention computed in f32 from the same
# bf16 q, k, v (f32_attention); measured on an H100: serving logits
# (|logits| up to 7.5) kernel 0.42 max / 0.053 mean, plain 0.66 / 0.073,
# so 0.64 / 0.074 between them; llama_7b's gradients at 2 layers, worst
# leaf relative to its max-abs, kernel 0.017, plain 0.031, 0.029 between
# them. The kernel path is the nearer one; the limits hold the distance
# between the two paths to about twice (logits) and three times
# (gradients) what was measured, and a kernel defect (a lost mask, a wrong
# scale or operand) moves it by O(1).
LLAMA_LOGITS_MAX_TOL = 1.5
LLAMA_LOGITS_MEAN_TOL = 0.15
LLAMA_GRAD_PATH_REL_TOL = 0.1

# the MoE paths against their plain attention path. Routing is discrete:
# bf16 noise between the two attention paths sends a near-tie choice to
# another expert, which moves that token's output by O(1), shifts the
# queue places (so the drops) of later tokens of that expert, and reaches
# later tokens through attention and later layers through the residual.
# Measured on an H100 (gpt2_124m(moe_experts=8), 12 layers; four runs):
# serving 8 x 1024 tokens, 35 of 16,384 decisions differ between the two
# paths in the first layer (0.21 %) and 4.8 % over all layers, and each
# path differs from attention computed in f32 as much as from the other
# (kernel 5.3 %, plain 5.0 %); in the B 8 gradient check after 8 training
# steps, 0.21-0.26 % in the first layer and 0.74-1.34 % in all (the
# trained state differs from run to run: flash_bwd sums dq in a
# run-dependent order). A kernel defect moves most decisions, the first
# layer's most of all. The free-running serving logits then differ by up
# to their own size at the tokens routed otherwise (max 3.41 with
# |logits| up to 3.52; mean 0.047, while kernel and plain are 0.052 and
# 0.048 from the f32 path), the B 8 loss by 1.2e-5 to 1.7e-4 and the
# worst gradient by 0.031 to 0.067 (kernel 0.037-0.061 and plain
# 0.033-0.048 from the f32 path). The limits below are about twice
# those. The tight check is the plain path run on the kernel path's
# routing, held to the dense GPT-2 limits (measured: logits 0.047 max,
# 0.0057 mean; worst gradient 0.0051-0.0087).
MOE_FIRST_LAYER_FLIP_SHARE_TOL = 0.01
MOE_FLIP_SHARE_TOL = 0.1
MOE_LOGITS_MAX_TOL = 7.0
MOE_LOGITS_MEAN_TOL = 0.1
MOE_LOSS_TOL = LOSS_TOL
MOE_GRAD_PATH_REL_TOL = 0.15
# moe_mlp against moe_mlp_plain on the same inputs, relative to the plain
# version's max-abs: both dispatch exact copies of the tokens and run the
# same expert products; the combine sums a token's k (= 2) products in f32
# in both, so y may differ by one bf16 step at most (2**-8); gradients
# reach the router through the gate's gradient, rounded to bf16 after
# products summed in other orders (GRAD_REL_TOL, as the kernels'); f32
# differs only by summation order. aux: the same f32 formula on the same
# routing (1e-6 relative).
MOE_Y_REL_TOL = {torch.bfloat16: 2 ** -8, torch.float32: 1e-5}
MOE_GRAD_REL_TOL = {torch.bfloat16: GRAD_REL_TOL, torch.float32: 1e-5}
MOE_AUX_REL_TOL = 1e-6
MOE_EXPERTS = 8

N_REQUESTS, REQUEST_BATCH = 4, 8
TRAIN_BATCH, TRAIN_STEPS, COMPARE_BATCH = 24, 8, 8
# llama_7b: requests of 2 x 4096 tokens; llama_1b: TinyLlama's per-GPU
# micro-batch of 8 x 2048 tokens, its gradients checked on one sequence
# (the plain path keeps [B, 32, 2048, 2048] probabilities per layer);
# llama_7b's hd-128 gradients checked at 2 of its 32 layers
LLAMA_REQUESTS, LLAMA_REQUEST_BATCH = 4, 2
LLAMA_TRAIN_BATCH, LLAMA_COMPARE_BATCH = 8, 1
LLAMA_GRAD_LAYERS = 2


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
        if m:   # int and bool template arguments, in order
            args = re.findall(r"L[ib](\d+)E", m.group(1))
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
            if f"{name}_kernelILi" in e["entry"]:   # the main kernel's <HD, ...>
                row["smem_dynamic"] = smem_bytes[name](*map(int, e["template"]))
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
    del q8, k8, v8
    ql, kl, vl = rand(LLAMA_REQUEST_BATCH, 32, 4096, 128)
    rows["llama_serve"], _, _ = check(
        f"causal B{LLAMA_REQUEST_BATCH} H32 S4096 hd128 (llama_7b serving shape)",
        ql, kl, vl, library=sdpa(ql, kl, vl, True))
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


def backward_call(q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True, lib=None):
    """The backward's C call alone, on outputs and scratch allocated once:
    its three kernels (prologue, main kernel, dq's cast) without the
    wrapper's checks and allocations. `lib`: another build with the same C
    entry point (default: the one of ops/csrc/)."""
    from ray_tpu_torch.ops import _build, attention as A

    B, H, Sq, hd = q.shape
    current = _build.load(A.BWD_KERNEL)
    lib = lib or current
    scratch = torch.empty(A._scratch_bytes(current)(B * H, Sq, hd) // 4,
                          dtype=torch.float32, device="cuda")
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    fn = A._entry(lib, "flash_bwd_bf16", 10)
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, *outs, scratch)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(*ptrs, B, H, Sq, k.shape[2], hd, q_off, kv_off,
                        hd ** -0.5, int(causal), stream), "flash_bwd_bf16")
        return outs
    call.scratch = scratch   # alive as long as the call: the kernel writes it
    return call


def compare_backward(src: str, gen):
    """Time the flash_bwd built from another source `src` with the same C
    entry point (e.g. an earlier design unpacked from git history) against
    the one in ops/csrc/, in turns old, new, new, old, at the training and
    serving shapes and at hd 128. Both are first held against the plain
    version, by max error (GRAD_REL_TOL; the old one must pass it) and by
    mean error (printed for both), and SDPA's flash backward is timed beside
    them."""
    from ray_tpu_torch.ops import _build, attention as A

    out = _build.BUILD_DIR / "libflash_bwd_compare.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    # a header the source includes is looked up beside it, then in csrc/
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(out), src],
                           check=True, capture_output=True, text=True, timeout=600)
    spills = sum(e["spill_stores"] + e["spill_loads"]
                 for e in ptxas_report(built.stdout + built.stderr))
    lib = ctypes.CDLL(str(out))

    for B, hd in ((TRAIN_BATCH, 64), (REQUEST_BATCH, 64), (REQUEST_BATCH, 128)):
        q, k, v, do = (torch.randn(B, 12, 1024, hd, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = A.mha_forward_kernel(q, k, v)
        args = (q, k, v, o, lse, do)
        old, new = backward_call(*args, lib=lib), backward_call(*args)
        ref = A.mha_backward_plain(*args)
        errs, mean_errs = {}, {}
        for name, f in (("old", old), ("new", new)):
            got = f()
            torch.cuda.synchronize()
            errs[name] = {n: rel_err(a, b)
                          for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
            mean_errs[name] = {n: mean_rel_err(a, b)
                               for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        del ref
        ms = [cuda_ms(f) for f in (old, new, new, old)]
        row = dict(shape=[B, 12, 1024, hd], src=src, spill_bytes=spills,
                   rel_err=errs, mean_rel_err=mean_errs,
                   old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]],
                   speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]),
                   sdpa_backward_ms=cuda_ms(sdpa_backward(q, k, v, do, True)))
        log(f"[compare-bwd] {json.dumps(row)}")
        if not all(e <= GRAD_REL_TOL for d in errs.values() for e in d.values()):
            fail(f"compared backward kernels disagree with the plain version: "
                 f"{errs}")


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
        mean_errs = {n: mean_rel_err(a, b)
                     for n, a, b in zip(("dq", "dk", "dv"), out, ref)}
        del ref
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
        if not all(e <= MEAN_REL_TOL for e in mean_errs.values()):
            fail(f"flash_bwd case {name}: mean relative errors {mean_errs} "
                 f"(tol {MEAN_REL_TOL})")
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
    del q, k, v, do, o, lse, q8, k8, v8, d8, o8, lse8, full, tail, parts

    # the Llama paths' shapes: llama_1b's training step (hd 64, 32 heads,
    # forward and backward) and llama_7b's hd-128 gradient check
    name = f"causal B{LLAMA_TRAIN_BATCH} H32 S2048 hd64 (llama_1b training shape)"
    q, k, v, do = rand(LLAMA_TRAIN_BATCH, 32, 2048, 64)
    rows["fwd_llama_train"], o, lse = forward_case(name, q, k, v,
                                                   library=sdpa(q, k, v, True))
    rows["llama_train"], _ = check(name, q, k, v, o, lse, do,
                                   library=sdpa_backward(q, k, v, do, True))
    del q, k, v, do, o, lse
    q, k, v, do = rand(1, 32, 4096, 128)
    o, lse = forward(q, k, v)
    rows["llama_hd128"], _ = check(
        "causal B1 H32 S4096 hd128 (llama_7b gradient check shape)",
        q, k, v, o, lse, do, library=sdpa_backward(q, k, v, do, True))
    return rows


# --------------------------------------------------------------------------- #
# Phases 3 to 7: the model paths
# --------------------------------------------------------------------------- #

def reset_launches() -> None:
    from ray_tpu_torch.ops import attention as A

    A.mha_forward_kernel.launches = 0
    A.mha_backward_kernel.launches = 0


def launches_since_reset() -> dict:
    from ray_tpu_torch.ops import attention as A

    return {"flash_fwd": A.mha_forward_kernel.launches,
            "flash_bwd": A.mha_backward_kernel.launches}


@contextmanager
def f32_attention(model):
    """Within the block, `model`'s attention (models.gpt2 or models.llama)
    is computed in f32 from its bf16 q, k and v (k and v repeated to q's
    heads as the model repeats them): a reference nearer exact arithmetic
    than either the kernel or the plain path, to measure each against. The
    port never runs it."""
    def attention(q, k, v, cfg):
        groups = q.shape[1] // k.shape[1]
        k, v = (x.repeat_interleave(groups, dim=1) for x in (k, v))
        S = q.shape[2]
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        return (p @ v.float()).to(q.dtype)

    kept, model._attention = model._attention, attention
    try:
        yield
    finally:
        model._attention = kept


def is_moe(cfg) -> bool:
    return getattr(cfg, "moe_experts", 0) > 0


@contextmanager
def recorded_routing(model, sink: list):
    """Within the block, each call of `model`'s MoE layer (models.gpt2)
    appends its routing (an ops.moe.Routing, by ops.moe.route on the
    layer's own inputs) to `sink`; the layer runs unchanged."""
    from ray_tpu_torch.ops import moe

    layer = model.moe_mlp

    def recording(x, params, *, top_k, capacity_factor, dtype):
        T = x.shape[0] * x.shape[1]
        C = moe.moe_capacity(T, params["router_w"].shape[-1], top_k,
                             capacity_factor)
        with torch.no_grad():
            sink.append(moe.route(x.detach().reshape(T, -1),
                                  params["router_w"].detach(), top_k, C))
        return layer(x, params, top_k=top_k, capacity_factor=capacity_factor,
                     dtype=dtype)

    model.moe_mlp = recording
    try:
        yield
    finally:
        model.moe_mlp = layer


@contextmanager
def routing_of(model, cfg, routing: dict, path):
    """recorded_routing into routing[path] for an MoE configuration and a
    named path, nothing otherwise."""
    if not is_moe(cfg) or path is None:
        yield
        return
    with recorded_routing(model, routing[path]):
        yield


@contextmanager
def forced_routing(recorded: list):
    """Within the block, the MoE layers of successive calls take their
    discrete decisions (expert, queue place, kept) from `recorded`, a run's
    routing in layer order, instead of from their own router; probabilities
    and gates are still computed from the layer's inputs, so gradients
    flow as usual. Two attention paths compared on one routing differ by
    their attention alone."""
    from ray_tpu_torch.ops import moe

    own, decisions = moe.route, iter(recorded)

    def route(xt, router_w, top_k, capacity):
        r = next(decisions)
        probs = moe.router_probs(xt, router_w)
        gate = moe._renormalise(probs.gather(1, r.expert))
        return moe.Routing(probs, gate, r.expert, r.pos, r.keep)

    moe.route = route
    try:
        yield
    finally:
        moe.route = own


def routing_flips(a: list, b: list) -> dict:
    """The (token, choice) routing decisions of two runs of one MoE model
    (per layer, routings with .expert and .keep [T, k], as recorded_routing
    gives them) that differ: in the expert chosen, and in whether the
    choice was kept or dropped; in all and layer by layer."""
    if len(a) != len(b) or not a:
        fail(f"routing recorded for {len(a)} and {len(b)} layers")
    experts = [int((ra.expert != rb.expert).sum()) for ra, rb in zip(a, b)]
    drops = [int((ra.keep != rb.keep).sum()) for ra, rb in zip(a, b)]
    return {
        "decisions": sum(r.expert.numel() for r in a),
        "expert_differs": sum(experts), "drop_differs": sum(drops),
        "expert_differs_by_layer": experts, "drop_differs_by_layer": drops,
        "dropped": sum(int((~r.keep).sum()) for r in a),
    }


def report_routing(tag: str, routing: dict) -> dict:
    """Print the routing decisions that differ between the kernel, plain
    and f32-attention paths; returns those between kernel and plain."""
    for path in ("kernel", "plain"):
        log(f"[{tag}] routing, {path} path vs attention in f32: "
            f"{json.dumps(routing_flips(routing[path], routing['f32']))}")
    flips = routing_flips(routing["kernel"], routing["plain"])
    log(f"[{tag}] routing, kernel path vs plain path: {json.dumps(flips)}")
    return flips


def check_flips(tag: str, flips: dict) -> None:
    share = max(flips["expert_differs"], flips["drop_differs"]) / flips["decisions"]
    per_layer = flips["decisions"] / len(flips["expert_differs_by_layer"])
    first = max(flips["expert_differs_by_layer"][0],
                flips["drop_differs_by_layer"][0]) / per_layer
    log(f"[{tag}] share of routing decisions that differ between the kernel "
        f"and plain paths: {share} (tol {MOE_FLIP_SHARE_TOL}), first layer "
        f"{first} (tol {MOE_FIRST_LAYER_FLIP_SHARE_TOL})")
    if not (share <= MOE_FLIP_SHARE_TOL
            and first <= MOE_FIRST_LAYER_FLIP_SHARE_TOL):
        fail(f"{tag}: the MoE routing of the kernel and plain paths differs "
             f"in {share} of its decisions, {first} in the first layer")


def executed_flops_per_token(model, cfg, num_tokens: int) -> float:
    """Training FLOPs per token that the card executes: 6 per parameter a
    token's work runs through, plus the attention term, as
    model.flops_per_token counts them, except that an MoE layer runs its
    E x C capacity slots per T tokens, filled or empty (about k x the
    capacity factor experts a token), where flops_per_token (the JAX
    formula) counts all E experts for every token."""
    if not is_moe(cfg):
        return model.flops_per_token(cfg)
    from ray_tpu_torch.ops import moe

    n = model.param_count(cfg)
    attention = model.flops_per_token(cfg) - 6.0 * n
    E, D, F_ = cfg.moe_experts, cfg.d_model, cfg.d_ff
    one_expert = cfg.n_layer * (2 * D * F_ + F_ + D)   # fc and out, all layers
    C = moe.moe_capacity(num_tokens, E, cfg.moe_top_k, cfg.moe_capacity_factor)
    slots_per_token = E * C / num_tokens
    return 6.0 * (n - E * one_expert + slots_per_token * one_expert) + attention


def moe_case(x, params, dy, dtype, capacity_factor, top_k=2) -> dict:
    """moe_mlp against moe_mlp_plain on the same inputs: routing decision
    for decision, y, aux and the gradients of sum(y * dy) + aux with
    respect to x and every parameter; two calls of moe_mlp bitwise equal;
    both timed, forward (no grad) and forward + backward."""
    from ray_tpu_torch.ops import moe

    B, S, D = x.shape
    T = B * S
    E = params["router_w"].shape[-1]
    C = moe.moe_capacity(T, E, top_k, capacity_factor)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, dtype=dtype)
    with torch.no_grad():
        r = moe.route(x.reshape(T, D), params["router_w"], top_k, C)
        rp = moe.route_plain(x.reshape(T, D), params["router_w"], top_k, C)[0]
    same_routing = {n: torch.equal(getattr(r, n), getattr(rp, n))
                    for n in ("expert", "pos", "keep")}
    dropped = 1.0 - r.keep.float().mean().item()

    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in params.items()}
    xg = x.detach().clone().requires_grad_(True)

    def fwd_bwd(fn):
        for t in (xg, *leaves.values()):
            t.grad = None
        y, aux = fn(xg, leaves, **kw)
        ((y.float() * dy).sum() + aux).backward()
        return y.detach(), aux.detach(), {"x": xg.grad, **{
            n: v.grad for n, v in leaves.items()}}

    y, aux, g = fwd_bwd(moe.moe_mlp)
    y2, aux2, g2 = fwd_bwd(moe.moe_mlp)
    bitwise = (torch.equal(y, y2) and torch.equal(aux, aux2)
               and all(torch.equal(g[n], g2[n]) for n in g))
    del y2, aux2, g2
    yp, auxp, gp = fwd_bwd(moe.moe_mlp_plain)
    torch.cuda.synchronize()
    y_err = rel_err(y, yp)
    aux_err = abs(aux.item() - auxp.item()) / abs(auxp.item())
    grad_errs = {n: rel_err(g[n], gp[n]) for n in g}
    del yp, gp

    def forward(fn):
        def call():
            with torch.no_grad():
                return fn(x, params, **kw)
        return call

    times = {
        "ms": cuda_ms(forward(moe.moe_mlp), iters=10),
        "plain_ms": cuda_ms(forward(moe.moe_mlp_plain), iters=5, warmup=1),
        "fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(moe.moe_mlp), iters=10),
        "plain_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(moe.moe_mlp_plain), iters=5,
                                    warmup=1),
    }
    F_ = params["fc_w"].shape[-1]
    expert_flops = 4 * E * C * D * F_       # the two expert products, forward
    row = dict(dtype=str(dtype).replace("torch.", ""), tokens=T, experts=E,
               top_k=top_k, capacity_factor=capacity_factor, capacity=C,
               slots_per_token=E * C / T, dropped_share=dropped,
               same_routing=same_routing, bitwise_repeatable=bitwise,
               y_rel_err=y_err, aux_rel_err=aux_err, grad_rel_err=grad_errs,
               expert_product_flops=expert_flops, **times)
    log(f"[moe] {json.dumps(row)}")
    y_tol, grad_tol = MOE_Y_REL_TOL[dtype], MOE_GRAD_REL_TOL[dtype]
    if not all(same_routing.values()):
        fail(f"moe_mlp routes otherwise than moe_mlp_plain: {same_routing}")
    if not bitwise:
        fail("two calls of moe_mlp differ")
    if not (y_err <= y_tol and aux_err <= MOE_AUX_REL_TOL
            and all(e <= grad_tol for e in grad_errs.values())):
        fail(f"moe_mlp disagrees with moe_mlp_plain: y {y_err} (tol {y_tol}), "
             f"aux {aux_err} (tol {MOE_AUX_REL_TOL}), gradients {grad_errs} "
             f"(tol {grad_tol})")
    return row


def moe_layer_cases(gen) -> list:
    """Phase [moe]: the MoE layer at GPT-2-124M's width with 8 experts, one
    request's tokens (REQUEST_BATCH x 1024), random weights at the init's
    scales with nonzero biases (so that the bias adds and the empty slots'
    outputs count), in bf16 and f32, at capacity factors 1.25 and 0.5."""
    from ray_tpu_torch.ops import moe

    D, F_ = 768, 3072
    params = {n: v[0] for n, v in moe.moe_init(gen, 1, D, F_, MOE_EXPERTS,
                                                device="cuda").items()}
    for n in ("fc_b", "out_b"):
        params[n] = 0.02 * torch.randn(params[n].shape, generator=gen,
                                       device="cuda")
    x = torch.randn(REQUEST_BATCH, 1024, D, generator=gen, device="cuda")
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    rows = []
    for cf in (1.25, 0.5):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(moe_case(x.to(dtype), params, dy, dtype, cf))
    if not rows[-1]["dropped_share"] > 0:
        fail("capacity factor 0.5 dropped no choice")
    return rows


def free_device_memory() -> None:
    """Between paths: free what the last one left, so that each path's peak
    memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_path(card: str, profile: bool, tag: str, name: str, model, cfg,
               n_requests: int, batch: int, logits_tol) -> int:
    """`model` (models.gpt2 or models.llama) at `cfg` with random weights from
    a seeded generator, in a Checkpoint served by a TorchPredictor that
    answers n_requests requests of batch x seq_len tokens. Launch counts are
    set to 0 just before and read just after: flash_fwd must have run once
    per layer per request, flash_bwd never. The logits of the first request
    are checked against the same weights through the plain attention path,
    within logits_tol = (max, mean); with MoE the routing decisions that
    differ between the two paths are counted and bounded. Returns
    flash_fwd's launches."""
    from ray_tpu_torch.train.batch_predictor import TorchPredictor
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.train_step import synthetic_batch

    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {name}: {model.param_count(cfg)} params, L={cfg.n_layer} "
        f"D={cfg.d_model} H={cfg.n_head} hd={cfg.d_model // cfg.n_head} "
        f"S={cfg.seq_len} vocab={cfg.padded_vocab}, {cfg.dtype}; init "
        f"{time.perf_counter() - t0:.2f} s")

    def apply_fn(params, batch):
        logits = model.forward(params, batch["tokens"], cfg)[:, -1, :cfg.vocab_size]
        best = logits.float().max(dim=-1)
        return {"next_token": best.indices, "logit": best.values}

    predictor = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), apply_fn=apply_fn,
        device="cuda")
    requests = [synthetic_batch(cfg, batch, seed=i)["tokens"]
                for i in range(n_requests)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    answers, times = [], []
    for tokens in requests:
        t = time.perf_counter()
        answers.append(predictor.predict({"tokens": tokens}))  # numpy: synced
        times.append(time.perf_counter() - t)
    launches = launches_since_reset()
    peak = torch.cuda.max_memory_allocated()

    expected = cfg.n_layer * n_requests
    log(f"[{tag}] flash_fwd launches: {launches['flash_fwd']} (expected "
        f"{expected}), flash_bwd {launches['flash_bwd']} (expected 0)")
    if launches != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"{name} serving path launched {launches}, expected flash_fwd "
             f"{expected} and flash_bwd 0")
    for ans in answers:
        tok, logit = ans["next_token"], ans["logit"]
        if tok.shape != (batch,) or not (
                (tok >= 0).all() and (tok < cfg.vocab_size).all()):
            fail(f"predictions out of range: {tok}")
        if not all(map(math.isfinite, logit.tolist())):
            fail(f"non-finite logits: {logit}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[{tag}] " + json.dumps(dict(
        card=card, model=name, requests=n_requests, batch=batch,
        seq_len=cfg.seq_len, request_ms=[t * 1e3 for t in times],
        median_after_first_ms=steady * 1e3,
        tokens_per_s=batch * cfg.seq_len / steady, peak_memory_bytes=peak,
        next_tokens=answers[0]["next_token"].tolist(),
    )))

    # the same weights and batch through the plain attention path
    toks = torch.as_tensor(requests[0], device="cuda")
    plain_cfg = replace(cfg, attention_impl="xla")
    routing = {"kernel": [], "plain": [], "f32": []}

    def logits(impl_cfg, path=None):
        with torch.inference_mode(), routing_of(model, cfg, routing, path):
            return model.forward(params, toks, impl_cfg).float()

    lk, lp = logits(cfg, "kernel"), logits(plain_cfg, "plain")
    with f32_attention(model):
        lf = logits(cfg, "f32")
    for path, out in (("kernel", lk), ("plain", lp)):
        d = (out - lf).abs()
        log(f"[{tag}] {path} path vs attention in f32: max |err| "
            f"{d.max().item()}, mean |err| {d.mean().item()}")
    del lf, d
    checks = [("plain attention path", lp, logits_tol)]
    if is_moe(cfg):
        flips = report_routing(tag, routing)
        with forced_routing(routing["kernel"]):
            checks.append(("plain attention path on the kernel path's routing",
                           logits(plain_cfg), (LOGITS_MAX_TOL, LOGITS_MEAN_TOL)))
    failed = []
    for what, ref, (max_tol, mean_tol) in checks:
        diff = (lk - ref).abs()
        agree = (lk[:, :, :cfg.vocab_size].argmax(-1)
                 == ref[:, :, :cfg.vocab_size].argmax(-1)).float().mean().item()
        log(f"[{tag}] logits vs {what}: max |err| {diff.max().item()} (tol "
            f"{max_tol}), mean |err| {diff.mean().item()} (tol {mean_tol}), "
            f"|logits| max {ref.abs().max().item()}, argmax agreement {agree}")
        if not (torch.isfinite(lk).all() and diff.max().item() <= max_tol
                and diff.mean().item() <= mean_tol):
            failed.append(what)
    del lk, lp, checks, diff
    if is_moe(cfg):
        check_flips(tag, flips)
    if failed:
        fail(f"{name} serving logits disagree with the {failed}")

    if profile:
        profile_device_time(f"one {name} request",
                            lambda: predictor.predict({"tokens": requests[0]}))
    return launches["flash_fwd"]


_CATEGORIES = (        # kernel name fragment -> category, first match wins
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_bwd", "flash_bwd (prologue, main kernel, dq cast)"),
    ("nvjet", "matrix products (cuBLAS)"), ("gemm", "matrix products (cuBLAS)"),
    ("index", "indexing (MoE dispatch and combine, embedding lookup)"),
    ("gather", "indexing (MoE dispatch and combine, embedding lookup)"),
    ("scatter", "indexing (MoE dispatch and combine, embedding lookup)"),
    ("sort", "MoE routing (sort, scan)"), ("scan", "MoE routing (sort, scan)"),
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


def compare_gradients(tag: str, model, cfg, params, batch, grad_tol,
                      loss_tol=LOSS_TOL) -> None:
    """The loss and every parameter's gradient of one batch, flash kernels
    against the plain attention path of the same model, within loss_tol and
    grad_tol of each leaf's max-abs; with MoE the routing decisions that
    differ between the two paths are counted and bounded."""
    from ray_tpu_torch.train.train_step import named_leaves, param_leaves

    leaves = param_leaves(params)
    names = [name for name, _ in named_leaves(params)]
    routing = {"kernel": [], "plain": [], "f32": []}
    plain_cfg = replace(cfg, attention_impl="xla")

    def loss_and_grads(impl_cfg, path=None):
        with routing_of(model, cfg, routing, path):
            loss = model.loss_fn(params, batch["tokens"], batch["targets"],
                                 impl_cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    lk, gk = loss_and_grads(cfg, "kernel")
    lp, gp = loss_and_grads(plain_cfg, "plain")
    with f32_attention(model):
        lf, gf = loss_and_grads(cfg, "f32")
    for path, loss, grads in (("kernel", lk, gk), ("plain", lp, gp)):
        errs = {n: rel_err(a, b) for n, a, b in zip(names, grads, gf)}
        far = max(errs, key=errs.get)
        log(f"[{tag}] {path} path vs attention in f32: loss {loss} vs {lf}, "
            f"worst gradient {far} {errs[far]}")
    del gf
    checks = [("plain attention path", lp, gp, loss_tol, grad_tol)]
    if is_moe(cfg):
        flips = report_routing(tag, routing)
        with forced_routing(routing["kernel"]):
            checks.append(("plain attention path on the kernel path's routing",
                           *loss_and_grads(plain_cfg), LOSS_TOL,
                           GRAD_PATH_REL_TOL))
    failed = []
    for what, loss, grads, l_tol, g_tol in checks:
        by_leaf = {n: rel_err(a, b) for n, a, b in zip(names, gk, grads)}
        worst = max(by_leaf, key=by_leaf.get)
        log(f"[{tag}] B{len(batch['tokens'])} vs {what}: loss flash {lk} vs "
            f"{loss} (tol {l_tol}); gradient relative errors "
            f"{json.dumps(by_leaf)}, worst {worst} {by_leaf[worst]} (tol "
            f"{g_tol})")
        if not (abs(lk - loss) <= l_tol and by_leaf[worst] <= g_tol):
            failed.append(what)
    if is_moe(cfg):
        check_flips(tag, flips)
    if failed:
        fail(f"{tag}: loss or gradients disagree with the {failed}")


def train_path(card: str, profile: bool, tag: str, name: str, model,
               make_train_step, cfg, batch: int, compare_batch: int,
               grad_tol: float, loss_tol: float = LOSS_TOL) -> dict:
    """make_train_step(cfg, device="cuda") (remat as cfg says), one warm-up
    step, then TRAIN_STEPS steps on one repeated synthetic batch of
    batch x seq_len tokens. Launch counts are set to 0 just before the
    steps and read just after: flash_fwd and flash_bwd must each have run
    once per layer per step. Loss and grad norm must be finite and the loss
    must fall. The share of 989 TFLOP/s is printed from the work the card
    executes and from the JAX formula (flops_per_token; the two differ only
    with MoE). Then the loss and gradients of one compare_batch batch are
    checked against the plain attention path (loss_tol, grad_tol). Returns
    the launches."""
    from ray_tpu_torch.train.train_step import default_optimizer, synthetic_batch

    t0 = time.perf_counter()
    bundle = make_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = {k: torch.as_tensor(v, device="cuda")   # device-resident batch
              for k, v in synthetic_batch(cfg, batch, seed=0).items()}
    state = bundle.state
    state, _ = bundle.step_fn(state, tokens)         # warm-up step
    torch.cuda.synchronize()
    log(f"[{tag}] {name} B={batch} S={cfg.seq_len} remat={cfg.remat}; init "
        f"and warm-up step {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = bundle.step_fn(state, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(m)
    launches = launches_since_reset()
    peak = torch.cuda.max_memory_allocated()

    expected = cfg.n_layer * TRAIN_STEPS
    log(f"[{tag}] launches: {json.dumps(launches)} (expected {expected} each)")
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"{name} training path launched {launches}, expected {expected} each")
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    if not all(map(math.isfinite, losses + norms)):
        fail(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_s = sorted(times)[len(times) // 2]
    tokens_per_s = batch * cfg.seq_len / step_s
    executed = executed_flops_per_token(model, cfg, batch * cfg.seq_len)
    log(f"[{tag}] " + json.dumps(dict(
        card=card, model=name, batch=batch, seq_len=cfg.seq_len,
        steps=TRAIN_STEPS, loss=losses, grad_norm=norms,
        step_ms=[t * 1e3 for t in times], step_ms_median=step_s * 1e3,
        tokens_per_s=tokens_per_s, peak_memory_bytes=peak,
        executed_flops_per_token=executed,
        share_of_989_tflops_executed=executed * tokens_per_s / PEAK_BF16_FLOPS,
        jax_formula_flops_per_token=model.flops_per_token(cfg),
        share_of_989_tflops_jax_formula=model.flops_per_token(cfg)
        * tokens_per_s / PEAK_BF16_FLOPS,
    )))
    if profile:
        def one_step():
            bundle.step_fn(state, tokens)
            torch.cuda.synchronize()
        profile_device_time(f"one {name} training step", one_step, top=16)

    compare_gradients(tag, model, cfg, state["params"],
                      synthetic_batch(cfg, compare_batch, seed=1), grad_tol,
                      loss_tol)
    return launches


def llama_hd128_gradients() -> None:
    """The hd-128 backward inside a model: llama_7b at full width and
    sequence, cut to LLAMA_GRAD_LAYERS layers, one sequence; loss and every
    gradient, flash kernels against the plain attention path. The kernel
    path launches each kernel once per layer, the plain path none."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.train_step import param_leaves, synthetic_batch

    cfg = llama.llama_7b(n_layer=LLAMA_GRAD_LAYERS)
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    for p in param_leaves(params):
        p.requires_grad_(True)
    log(f"[llama-hd128] llama_7b cut to {cfg.n_layer} of 32 layers, full width "
        f"(D={cfg.d_model} H={cfg.n_head} hd={cfg.head_dim}), S={cfg.seq_len}, "
        f"B=1")
    reset_launches()
    compare_gradients("llama-hd128", llama, cfg, params,
                      synthetic_batch(cfg, 1, seed=2), LLAMA_GRAD_PATH_REL_TOL)
    launches = launches_since_reset()
    expected = {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
    log(f"[llama-hd128] launches: {json.dumps(launches)} (expected "
        f"{json.dumps(expected)})")
    if launches != expected:
        fail(f"hd-128 gradient check launched {launches}, expected {expected}")


# --------------------------------------------------------------------------- #

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--compare-fwd", metavar="SRC",
                        help="also time flash_fwd built from SRC (same C "
                             "entry point) against the current one")
    parser.add_argument("--compare-bwd", metavar="SRC",
                        help="also time flash_bwd built from SRC (same C "
                             "entry point) against the current one")
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

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.train.train_step import (
        make_gpt2_train_step, make_llama_train_step,
    )

    free_device_memory()
    serve = serve_path(card, args.profile, "main", "gpt2_124m", gpt2,
                       gpt2.gpt2_124m(), N_REQUESTS, REQUEST_BATCH,
                       (LOGITS_MAX_TOL, LOGITS_MEAN_TOL))
    free_device_memory()
    train = train_path(card, args.profile, "train", "gpt2_124m", gpt2,
                       make_gpt2_train_step, gpt2.gpt2_124m(remat=False),
                       TRAIN_BATCH, COMPARE_BATCH, GRAD_PATH_REL_TOL)
    free_device_memory()
    llama_serve = serve_path(card, args.profile, "llama-serve", "llama_7b",
                             llama, llama.llama_7b(), LLAMA_REQUESTS,
                             LLAMA_REQUEST_BATCH,
                             (LLAMA_LOGITS_MAX_TOL, LLAMA_LOGITS_MEAN_TOL))
    free_device_memory()
    llama_train = train_path(card, args.profile, "llama-train", "llama_1b",
                             llama, make_llama_train_step,
                             llama.llama_1b(remat=False), LLAMA_TRAIN_BATCH,
                             LLAMA_COMPARE_BATCH, LLAMA_GRAD_PATH_REL_TOL)
    free_device_memory()
    llama_hd128_gradients()

    free_device_memory()
    moe_layer_cases(gen)
    free_device_memory()
    moe_cfg = gpt2.gpt2_124m(moe_experts=MOE_EXPERTS)
    moe_serve = serve_path(card, args.profile, "moe-serve", "gpt2_124m_moe8",
                           gpt2, moe_cfg, N_REQUESTS, REQUEST_BATCH,
                           (MOE_LOGITS_MAX_TOL, MOE_LOGITS_MEAN_TOL))
    free_device_memory()
    moe_train = train_path(card, args.profile, "moe-train", "gpt2_124m_moe8",
                           gpt2, make_gpt2_train_step,
                           replace(moe_cfg, remat=False), TRAIN_BATCH,
                           COMPARE_BATCH, MOE_GRAD_PATH_REL_TOL, MOE_LOSS_TOL)

    def numbers(row, launches):
        """One path's numbers for a kernel: its launches on that path beside
        the case run at that path's shape."""
        return {"launches": launches, "shape": row["shape"],
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "bound_share",
                                       "library_ms")}}

    # top level: GPT-2's training path at its own shape; by_path: each main
    # path at its own shape with its own launches
    fwd_paths = {
        "train": numbers(bwd["fwd_main"], train["flash_fwd"]),
        "serve": numbers(fwd["main"], serve),
        "llama_serve": numbers(fwd["llama_serve"], llama_serve),
        "llama_train": numbers(bwd["fwd_llama_train"], llama_train["flash_fwd"]),
        "moe_serve": numbers(fwd["main"], moe_serve),
        "moe_train": numbers(bwd["fwd_main"], moe_train["flash_fwd"]),
    }
    bwd_paths = {
        "train": numbers(bwd["main"], train["flash_bwd"]),
        "llama_train": numbers(bwd["llama_train"], llama_train["flash_bwd"]),
        "moe_train": numbers(bwd["main"], moe_train["flash_bwd"]),
    }
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

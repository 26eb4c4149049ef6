#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gan_codes_tpu_torch`) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failed check raises, so the run exits non-zero):

1. Build: compiles every kernel source in `gan_codes_tpu_torch/csrc/` with
   one nvcc call for sm_90a into one library, prints the build seconds and
   the card's name and power limit.
2. Kernels: calls each kernel's wrapper on the card at the shapes the main
   paths give it (batch 8): K2 at every DFBlock its `_supported` takes, K1
   and K1 bwd at the input of every DFBlock of a train step (14 DFBlocks,
   10 distinct shapes; the served forward runs K1 on the two K2 declines),
   in float32 with TF32 off and in bfloat16, and holds each result against
   the kernel's plain PyTorch version on the same inputs. Prints errors,
   kernel / plain / library times (CUDA events) and the bound, and K2's
   backward (its autograd Function) against the plain composition's
   autograd backward. K3 (`fused_resblock_g`, on no model path) runs at
   the 7 residual-block shapes of the 256px generator, batch 8, in both
   dtypes, against its plain version, with its time beside the port's
   current way to compute a block (`composition_ms`: K2, or K1 and cuDNN,
   per DFBlock, the cuDNN 1x1 shortcut, the residual add), and its backward
   (fp32) against the plain composition's autograd.
3. Serve: writes seeded random full-width weights (256px, n_channels=32,
   vocab 5450, embed 300, hidden 256, every block gamma != 0) as
   reference-format `gen_1.pth` + `text_encoder.pth` + `captions.pickle`,
   builds the sampler with `build_sampler`, serves it with
   `make_http_server` on 127.0.0.1, and drives POST /generate (prompts and
   captions, PNG and JPEG, then LATENCY_REQUESTS single-prompt requests one
   at a time, whose latency percentiles it prints), /healthz and /metrics.
   The kernels' launch counters are set to 0 just before the requests and
   must rise by exactly their share of 14 DFBlocks per dispatched batch.
   One batch with explicit noise is held against the same forward through
   the plain versions on the card. Prints the device time of a served batch
   by kernel group (torch.profiler) and Sampler throughput at batch 16 and
   64 in float32 and bfloat16, each over THROUGHPUT_WINDOWS windows of
   several seconds.
4. Train: builds seeded full-width train states (G 256px n_channels 32,
   D n_channels 32, every block gamma != 0) with `create_train_state`, a
   seeded text encoder and a seeded batch of TRAIN_BATCH images in [-1, 1]
   and random captions, and runs `make_train_step`'s 3-phase step:
   TRAIN_STEPS steps in float32 (TF32 off) with the launch counters set to
   0 just before and read just after (12 K2, 14 K1, 14 K1 bwd per step),
   then in bfloat16; every metric must be finite. Prints train img/s over
   two windows of at least TRAIN_WINDOW_S seconds (CUDA events), the peak
   device memory, the device time of a step by kernel group
   (torch.profiler) and of each phase apart (CUDA events). From one fp32
   state, the phase-3 G gradients against one D, and then one whole step,
   are held against the same through the plain versions.
5. Train entry: writes a synthetic CUB fixture (`make_synthetic_cub`,
   48 train and 24 test images of 256-511 px) and a seeded text encoder,
   then runs `train_entry.train` at full width (256px, n_channels 32,
   batch 24, fp32, 2 steps per epoch): run A, 2 epochs uninterrupted; run
   B, 1 epoch, then a second call with 2 epochs on the same directories,
   which must print "Resuming from epoch 1". Holds: the state B's second
   call restored equals the state B saved, bit for bit (parameters, EMA,
   Adam moments, step, RNG); B's second-epoch losses within rtol 1e-3 of
   A's (cuDNN is not deterministic run to run); the checkpoint files,
   one metrics row per epoch and the sample grid exist; the launch
   counters rise by 12 K2, 14 K1 and 14 K1 bwd per step plus 12 K2 and 2
   K1 per eval batch; `build_sampler` serves B's `gen_1.pth` over HTTP.
   Prints the trainer's img/s with the device time of its steps and
   copies and the host's data wait, eval and checkpoint seconds, beside
   the bare step's img/s of phase 4.
6. Prints one {"kernels": [...]} line, the nvidia-smi line, and, last,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without CUDA, or outside the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import base64
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 1234
KERNEL_BATCH = 8
LATENCY_REQUESTS = 300          # single-prompt HTTP requests, one at a time
THROUGHPUT_BATCHES = {16: 300, 64: 150}  # several seconds per window
THROUGHPUT_WINDOWS = 2
TRAIN_BATCH = 24                 # the JAX package's TrainConfig default
TRAIN_STEPS = 3                  # counted steps per dtype (main path)
TRAIN_WINDOW_S = 3.5             # seconds per train throughput window
ENTRY_TRAIN, ENTRY_TEST = 48, 24  # synthetic CUB images for the train entry
H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # CUDA cores, non-tensor
H100_BF16_TENSOR_FLOPS = 989e12  # dense tensor cores
# tolerances of the kernel checks (phase 2), each against the plain version
# on the same inputs:
#   K1 only rounds where the plain version rounds (no reduction): fp32
#   allclose(1e-6, 1e-6); bf16 max|err| <= 2^-7 * max|ref| (two ulps).
#   K2 sums 9*Cin products in another order than cuDNN: fp32
#   allclose(1e-4, 1e-4) with TF32 off; bf16 rounds the sum to bf16 before
#   the bias add, as the plain version does, so one-ulp flips of the
#   rounded sum are expected: max|err| <= 2^-6 * max|ref|.
#   K1 bwd: dx rounds where the plain version rounds: fp32 allclose(1e-6),
#   bf16 max|err| <= 2^-7 * max|ref|; dg1/db1/dg2/db2 add H*W products in
#   fp32 in another order: fp32 allclose(1e-4), bf16 <= 2^-6 * max|ref|.
#   K3 chains two convs, each summed in another order than cuDNN: fp32
#   allclose(2e-4, 2e-4); bf16 rounds h1 and h2 to bf16, so each conv may
#   flip one ulp: max|err| <= 2^-5 * max|ref|. Its backward (fp32) against
#   the plain composition's autograd: max|err| <= 1e-3 * max|ref| per input.
#   The served image (phase 3, fp32) passes 14 DFBlocks, each reordered:
#   allclose(1e-3, 1e-3).
#   Train (phase 4, fp32), kernels against the plain versions from one
#   state: the phase-3 G gradients against one D, and after one whole
#   step, max|err| <= 1e-3 * max|ref| over all G gradients (the convs'
#   sums are reordered; a scalar such as a block gamma sums 10^7 products
#   that cancel, so a per-tensor ratio is printed, not held); the step's
#   d_loss, d_gp_loss, g_loss rtol 1e-4. Adam with beta1 = 0 turns a
#   near-zero D gradient into +-lr, so parameters after the step are not
#   compared.
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls, after 3 warm calls,
    with CUDA events around the run."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dfblock_shapes(gcfg):
    """(H, Cin, Cout) of every DFBlock of one generator forward, in order."""
    shapes = []
    for i, (cin, cout) in enumerate(gcfg.block_channels):
        res = gcfg.base_size * 2 ** i
        shapes += [(res, cin, cout), (res, cout, cout)]
    return shapes


def _held(name: str, got, want, fp32: bool, tol_fp32: float,
          bf16_exp: int) -> float:
    """max|err| of got against want; raises outside the tolerance: fp32
    allclose(tol, tol), bf16 max|err| <= 2^bf16_exp * max|ref|."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    ok = (torch.allclose(got, want, atol=tol_fp32, rtol=tol_fp32) if fp32
          else err <= 2.0 ** bf16_exp * top)
    if not ok:
        raise AssertionError(f"{name}: max|err| {err} (max|ref| {top}) "
                             "outside tolerance")
    return err


def check_kernels(gcfg):
    """Phase 2. Returns per-kernel summaries for the kernels line and the
    per-forward counts of K2 and K1 launches on the served path."""
    import torch
    import torch.nn.functional as F

    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B = KERNEL_BATCH
    shapes = dfblock_shapes(gcfg)
    k2_shapes = [s for s in shapes if fused_modconv._supported(
        torch.empty(3, 3, s[1], s[2], device="meta"))]
    k1_path = [(s[0], s[1]) for s in shapes if s not in k2_shapes]
    # a train step runs K1 (forward, and backward) at every DFBlock input:
    # forward on the two K2 declines, and inside K2's backward on the rest
    k1_step = [(s[0], s[1]) for s in shapes]
    summary = {
        "fused_modconv3x3": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_modconv.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_modconv.py:118",
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
            max_abs_err=0.0, bound_by="operations", bwd_ms=0.0,
            plain_bwd_ms=0.0, per="served forward",
            path_shapes=len(k2_shapes)),
        "fused_double_affine_leaky": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_affine.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_affine.py:71",
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
            max_abs_err=0.0, bound_by="bytes", ms_per_train_step=0.0,
            per="served forward", path_shapes=len(k1_path)),
        "fused_double_affine_leaky_bwd": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_affine.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_affine.py:133",
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
            max_abs_err=0.0, bound_by="bytes", per="train step",
            path_shapes=len(k1_step)),
    }
    log(f"[kernels] per forward: K2 takes {len(k2_shapes)} DFBlocks "
        f"{k2_shapes}, K1 takes {len(k1_path)} {k1_path}; per train step "
        f"K1 and K1 bwd take all {len(k1_step)}")

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale
                ).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
        esize = 4 if fp32 else 2
        peak = H100_FP32_FLOPS if fp32 else H100_BF16_TENSOR_FLOPS
        for (hw, cin, cout) in k2_shapes:
            x = rand(B, hw, hw, cin, dtype=dtype)
            g1, b1, g2, b2 = (rand(B, cin, dtype=dtype) for _ in range(4))
            w = rand(3, 3, cin, cout, dtype=dtype, scale=(9 * cin) ** -0.5)
            bias = rand(cout, dtype=dtype, scale=0.1)
            args = (x, g1, b1, g2, b2, w, bias)
            out = fused_modconv.fused_modconv3x3(*args)
            ref = fused_modconv.reference_modconv3x3(*args)
            torch.cuda.synchronize()
            err = _held(f"K2 {name} {(B, hw, hw, cin, cout)}", out, ref,
                        fp32, 1e-4, -6)
            top = ref.float().abs().max().item()
            iters = 20 if hw >= 64 else 50
            ms = cuda_ms(lambda: fused_modconv.fused_modconv3x3(*args), iters)
            plain = cuda_ms(lambda: fused_modconv.reference_modconv3x3(*args),
                            iters)
            h = fused_affine.reference_double_affine_leaky(x, g1, b1, g2, b2)
            h_nchw = h.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            lib = cuda_ms(lambda: F.conv2d(h_nchw, w_oihw, bias, padding=1),
                          iters)
            n_bytes = (x.numel() + 4 * B * cin + w.numel() + cout
                       + B * hw * hw * cout) * esize
            flops = 2.0 * B * hw * hw * 9 * cin * cout
            b_ms, b_by = bound(n_bytes, flops, peak)
            log(f"[kernels] K2 {name} x[{B},{hw},{hw},{cin}] -> {cout}: "
                f"max_abs_err {err:.3g} max_rel_err {err / top:.3g} | "
                f"kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                f"library_ms {lib:.4f} bound_ms {b_ms:.4f} ({b_by}) | "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            if fp32:
                # K2's backward (K1 recompute, conv gradient, K1 bwd)
                # against the plain composition's autograd backward
                ins = [a.detach().requires_grad_() for a in args]
                dy = rand(B, hw, hw, cout, dtype=dtype)
                out = fused_modconv.fused_modconv3x3(*ins)
                ref = fused_modconv.reference_modconv3x3(*ins)
                bwd = cuda_ms(lambda: torch.autograd.grad(
                    out, ins, dy, retain_graph=True), iters)
                plain_bwd = cuda_ms(lambda: torch.autograd.grad(
                    ref, ins, dy, retain_graph=True), iters)
                log(f"[kernels] K2 backward fp32 x[{B},{hw},{hw},{cin}] -> "
                    f"{cout}: Function bwd_ms {bwd:.4f} plain autograd "
                    f"bwd_ms {plain_bwd:.4f}")
                s = summary["fused_modconv3x3"]
                s["ms"] += ms
                s["plain_ms"] += plain
                s["library_ms"] += lib
                s["bound_ms"] += b_ms
                s["bwd_ms"] += bwd
                s["plain_bwd_ms"] += plain_bwd
                s["max_abs_err"] = max(s["max_abs_err"], err)
                del ins, out, ref
        seen = {}
        for (hw, c) in k1_step:
            seen[(hw, c)] = seen.get((hw, c), 0) + 1
        for (hw, c), n_step in seen.items():
            x = rand(B, hw, hw, c, dtype=dtype)
            vecs = [rand(B, c, dtype=dtype) for _ in range(4)]
            dy = rand(B, hw, hw, c, dtype=dtype)
            out = fused_affine.fused_double_affine_leaky(x, *vecs)
            ref = fused_affine.reference_double_affine_leaky(x, *vecs)
            got_b = fused_affine.fused_double_affine_leaky_bwd(x, *vecs, dy)
            ref_b = fused_affine.reference_double_affine_leaky_bwd(x, *vecs,
                                                                   dy)
            torch.cuda.synchronize()
            tag = f"{name} {(B, hw, hw, c)}"
            err = _held(f"K1 {tag}", out, ref, fp32, 1e-6, -7)
            err_dx = _held(f"K1 bwd dx {tag}", got_b[0], ref_b[0], fp32,
                           1e-6, -7)
            err_v = max(_held(f"K1 bwd d{v} {tag}", g, r, fp32, 1e-4, -6)
                        for v, g, r in zip(("g1", "b1", "g2", "b2"),
                                           got_b[1:], ref_b[1:]))
            iters = 20 if hw >= 128 else 50
            ms = cuda_ms(lambda: fused_affine.fused_double_affine_leaky(
                x, *vecs), iters)
            plain = cuda_ms(lambda: fused_affine.reference_double_affine_leaky(
                x, *vecs), iters)
            bms = cuda_ms(lambda: fused_affine.fused_double_affine_leaky_bwd(
                x, *vecs, dy), iters)
            bplain = cuda_ms(
                lambda: fused_affine.reference_double_affine_leaky_bwd(
                    x, *vecs, dy), iters)
            n_bytes = (2 * x.numel() + 4 * B * c) * esize
            b_ms, b_by = bound(n_bytes, 6.0 * x.numel(), H100_FP32_FLOPS)
            # backward: read x and dy, write dx; read 4, write 4 [B, C]
            bb_bytes = (3 * x.numel() + 8 * B * c) * esize
            bb_ms, bb_by = bound(bb_bytes, 20.0 * x.numel(), H100_FP32_FLOPS)
            top = ref.float().abs().max().item()
            log(f"[kernels] K1 {name} x[{B},{hw},{hw},{c}] (x{n_step} per "
                f"step, {k1_path.count((hw, c))} per served forward): "
                f"max_abs_err {err:.3g} max_rel_err {err / top:.3g} | "
                f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
                f"{b_ms:.4f} ({b_by}) | {n_bytes / ms / 1e6:.0f} GB/s")
            log(f"[kernels] K1 bwd {name} x[{B},{hw},{hw},{c}] (x{n_step} "
                f"per step): max_abs_err dx {err_dx:.3g} dg/db {err_v:.3g} | "
                f"kernel_ms {bms:.4f} plain_ms {bplain:.4f} bound_ms "
                f"{bb_ms:.4f} ({bb_by}) | {bb_bytes / bms / 1e6:.0f} GB/s")
            if fp32:
                s = summary["fused_double_affine_leaky"]
                n_served = k1_path.count((hw, c))
                s["ms"] += n_served * ms
                s["plain_ms"] += n_served * plain
                s["bound_ms"] += n_served * b_ms
                s["ms_per_train_step"] += n_step * ms
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s = summary["fused_double_affine_leaky_bwd"]
                s["ms"] += n_step * bms
                s["plain_ms"] += n_step * bplain
                s["bound_ms"] += n_step * bb_ms
                s["max_abs_err"] = max(s["max_abs_err"], err_dx, err_v)
    return summary, len(k2_shapes), len(k1_path)


def resblock_shapes(gcfg):
    """(H, Cin, Cout) of every residual block of one generator forward."""
    return [(gcfg.base_size * 2 ** i, cin, cout)
            for i, (cin, cout) in enumerate(gcfg.block_channels)]


def check_resblock(gcfg):
    """Phase 2, K3: `fused_resblock_g` at every residual-block shape of the
    generator, batch 8, fp32 (TF32 off) and bf16, against its plain
    version; its time beside the plain version's and the composition's
    (the port's current way to compute the block); its fp32 backward
    against the plain composition's autograd. Returns the summary entry
    and the number of K3 launches the phase made."""
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_resblock as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    B = KERNEL_BATCH
    before = fr.fused_resblock_g.launches
    s = dict(route="cuda", source="gan_codes_tpu_torch/csrc/fused_resblock.cu",
             replaces="gan_codes_tpu/ops/pallas/fused_resblock.py:157",
             ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
             composition_ms=0.0, max_abs_err=0.0, bound_by="operations",
             bwd_ms=0.0, plain_bwd_ms=0.0, bf16_ms=0.0,
             bf16_composition_ms=0.0, bf16_bound_ms=0.0,
             per="7-block set (one 256px generator forward's blocks)",
             path_shapes=len(gcfg.block_channels))

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale
                ).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
        esize = 4 if fp32 else 2
        peak = H100_FP32_FLOPS if fp32 else H100_BF16_TENSOR_FLOPS
        for hw, cin, cout in resblock_shapes(gcfg):
            sc = cin != cout
            args = ([rand(B, hw, hw, cin, dtype=dtype)]
                    + [rand(B, cin, dtype=dtype, scale=0.5)
                       for _ in range(4)]
                    + [rand(3, 3, cin, cout, dtype=dtype,
                            scale=(9 * cin) ** -0.5),
                       rand(cout, dtype=dtype, scale=0.1)]
                    + [rand(B, cout, dtype=dtype, scale=0.5)
                       for _ in range(4)]
                    + [rand(3, 3, cout, cout, dtype=dtype,
                            scale=(9 * cout) ** -0.5),
                       rand(cout, dtype=dtype, scale=0.1),
                       torch.full((1,), 0.7, device=dev, dtype=dtype)]
                    + ([rand(1, 1, cin, cout, dtype=dtype, scale=cin ** -0.5),
                        rand(cout, dtype=dtype, scale=0.1)] if sc
                       else [None, None]))
            out = fr.fused_resblock_g(*args)
            ref = fr.reference_resblock_g(*args)
            torch.cuda.synchronize()
            err = _held(f"K3 {name} {(B, hw, hw, cin, cout)}", out, ref,
                        fp32, 2e-4, -5)
            top = ref.float().abs().max().item()
            iters = 5 if hw >= 128 else 10
            with torch.no_grad():
                ms = cuda_ms(lambda: fr.fused_resblock_g(*args), iters)
                plain = cuda_ms(lambda: fr.reference_resblock_g(*args),
                                iters)
                comp = cuda_ms(lambda: fr._composition(*args), iters)
            n_bytes = sum(a.numel() for a in args if a is not None) * esize \
                + B * hw * hw * cout * esize
            flops = 2.0 * B * hw * hw * cout * (9 * cin + 9 * cout
                                                + (cin if sc else 0))
            b_ms, b_by = bound(n_bytes, flops, peak)
            log(f"[kernels] K3 {name} x[{B},{hw},{hw},{cin}] -> {cout}"
                f"{' +1x1' if sc else ''}: max_abs_err {err:.3g} "
                f"max_rel_err {err / top:.3g} | kernel_ms {ms:.4f} plain_ms "
                f"{plain:.4f} composition_ms {comp:.4f} bound_ms "
                f"{b_ms:.4f} ({b_by}) | {flops / ms / 1e9:.1f} TFLOP/s")
            if not fp32:
                s["bf16_ms"] += ms
                s["bf16_composition_ms"] += comp
                s["bf16_bound_ms"] += b_ms
                continue
            s["ms"] += ms
            s["plain_ms"] += plain
            s["composition_ms"] += comp
            s["bound_ms"] += b_ms
            s["max_abs_err"] = max(s["max_abs_err"], err)
            # backward: the Function (K2 or K1 + cuDNN, K1 bwd) against the
            # plain composition's autograd, every input's gradient
            ins = [None if a is None else a.detach().requires_grad_()
                   for a in args]
            leaves = [a for a in ins if a is not None]
            dy = rand(B, hw, hw, cout, dtype=dtype)
            out = fr.fused_resblock_g(*ins)
            ref = fr.reference_resblock_g(*ins)
            got = torch.autograd.grad(out, leaves, dy, retain_graph=True)
            want = torch.autograd.grad(ref, leaves, dy, retain_graph=True)
            worst = 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                e = (g - w).abs().max().item()
                t = w.abs().max().item()
                worst = max(worst, e / max(t, 1e-30))
                if e > 1e-3 * t:
                    raise AssertionError(f"K3 backward input {i} at "
                                         f"{(B, hw, hw, cin, cout)}: max|err|"
                                         f" {e} max|ref| {t}")
            bwd = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, dy, retain_graph=True), iters)
            plain_bwd = cuda_ms(lambda: torch.autograd.grad(
                ref, leaves, dy, retain_graph=True), iters)
            s["bwd_ms"] += bwd
            s["plain_bwd_ms"] += plain_bwd
            log(f"[kernels] K3 backward fp32 x[{B},{hw},{hw},{cin}] -> "
                f"{cout}: worst per-input max|err|/max|ref| {worst:.3g}; "
                f"Function bwd_ms {bwd:.4f} plain autograd bwd_ms "
                f"{plain_bwd:.4f}")
            del ins, leaves, out, ref, got, want
    log(f"[kernels] K3 per 7-block set: fp32 kernel_ms {s['ms']:.3f} "
        f"plain_ms {s['plain_ms']:.3f} composition_ms "
        f"{s['composition_ms']:.3f} bound_ms {s['bound_ms']:.3f}; bf16 "
        f"kernel_ms {s['bf16_ms']:.3f} composition_ms "
        f"{s['bf16_composition_ms']:.3f} bound_ms {s['bf16_bound_ms']:.4f}")
    return s, fr.fused_resblock_g.launches - before


def write_weights(root: str) -> None:
    """Seeded random full-width reference-format weights + vocab."""
    import torch

    from gan_codes_tpu_torch.config import GeneratorConfig, TextEncoderConfig
    from gan_codes_tpu_torch.models.generator import Generator
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        g = Generator(GeneratorConfig())
        te = RNNEncoder(TextEncoderConfig())
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(".gamma"):  # away from the 0 init
                p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
    torch.save(g.state_dict(), os.path.join(root, "weights", "gen_1.pth"))
    torch.save(te.state_dict(), os.path.join(root, "text_encoder.pth"))
    words = ["<end>", "<unk>", "a", "this", "bird", "has", "red", "blue",
             "yellow", "small", "wings", "belly", "black", "white", "beak"]
    words += [f"w{i}" for i in range(5450 - len(words))]
    code2word = dict(enumerate(words))
    word2code = {w: i for i, w in code2word.items()}
    with open(os.path.join(root, "data", "captions.pickle"), "wb") as f:
        pickle.dump(([], [], code2word, word2code), f)


def post(url: str, payload: dict):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def get(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def serve(root: str, k2_per_forward: int, k1_per_forward: int):
    """Phase 3. Returns (K2 launches, K1 launches, served numbers)."""
    from unittest import mock

    import torch
    from PIL import Image

    from gan_codes_tpu_torch import serve as serve_mod
    from gan_codes_tpu_torch.ops import blocks, fusion
    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    K2 = fused_modconv.fused_modconv3x3
    K1 = fused_affine.fused_double_affine_leaky
    args = (os.path.join(root, "data"), os.path.join(root, "text_encoder.pth"),
            os.path.join(root, "weights"))
    sampler, epoch = serve_mod.build_sampler(*args, batch_size=16)
    gcfg = sampler.cfg.generator
    log(f"[serve] gen_{epoch}.pth: {gcfg.image_size}px n_channels "
        f"{gcfg.n_channels}, {sum(p.numel() for p in sampler.generator.parameters())} "
        f"G params; warmup {sampler.warmup():.2f}s")
    server = serve_mod.make_http_server(sampler, port=0, epoch=epoch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bs = sampler.batch_size
    batches = 0
    latencies = []
    try:
        K2.launches = K1.launches = 0  # main path starts here
        # free-text prompts -> PNG
        code, body = post(url, {"prompts": ["a small red bird",
                                            "this bird has blue wings",
                                            "a yellow bird, black beak."]})
        batches += 1
        if code != 200 or body["count"] != 3:
            raise AssertionError(f"prompts request: {code} {body}")
        for b64 in body["images"]:
            img = Image.open(io.BytesIO(base64.b64decode(b64)))
            arr = np.asarray(img)
            if img.format != "PNG" or arr.shape != (256, 256, 3):
                raise AssertionError(f"bad PNG {img.format} {arr.shape}")
        # caption tokens, 20 items -> two padded batches, JPEG
        caps = [[4, 6, 11, 2 + i % 10] for i in range(20)]
        code, body = post(url, {"captions": caps, "cap_lens": [4] * 20,
                                "format": "jpeg", "quality": 90})
        batches += -(-20 // bs)
        if code != 200 or body["count"] != 20 or body["format"] != "jpeg":
            raise AssertionError(f"captions request: {code} {body.keys()}")
        img = Image.open(io.BytesIO(base64.b64decode(body["images"][-1])))
        if img.format != "JPEG" or img.size != (256, 256):
            raise AssertionError(f"bad JPEG {img.format} {img.size}")
        # single-prompt request latency (host clock, request to response),
        # one request at a time
        for _ in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            code, body = post(url, {"prompts": ["a bird"]})
            latencies.append((time.perf_counter() - t0) * 1e3)
            batches += 1
            if code != 200 or body["count"] != 1:
                raise AssertionError(f"single prompt: {code}")
        k2, k1 = K2.launches, K1.launches  # main path ends here
        health = get(url, "/healthz")
        metrics = get(url, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    if health["status"] != "ok" or health["image_size"] != 256:
        raise AssertionError(f"/healthz {health}")
    if (metrics["generate_ok"] != 2 + LATENCY_REQUESTS
            or metrics["images_total"] != 23 + LATENCY_REQUESTS):
        raise AssertionError(f"/metrics {metrics}")
    log(f"[serve] {batches} batches dispatched over HTTP: K2 launches {k2}, "
        f"K1 launches {k1}; /metrics {metrics}")
    if k2 != k2_per_forward * batches or k1 != k1_per_forward * batches:
        raise AssertionError(
            f"launch counters K2 {k2} K1 {k1} != {k2_per_forward} and "
            f"{k1_per_forward} per batch x {batches} batches")

    # one served batch, explicit noise, against the plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = torch.randn((bs, gcfg.latent_dim), generator=gen, device="cuda")
    tok = np.random.default_rng(SEED)
    captions = tok.integers(1, 5450, (bs, 18))
    cap_lens = tok.integers(1, 19, (bs,))
    out = sampler.pipeline(captions, cap_lens, noise)
    with mock.patch.object(blocks, "fused_modconv3x3",
                           fused_modconv.reference_modconv3x3), \
            mock.patch.object(fusion, "fused_double_affine_leaky",
                              fused_affine.reference_double_affine_leaky):
        ref = sampler.pipeline(captions, cap_lens, noise)
    torch.cuda.synchronize()
    if out.shape != (bs, 256, 256, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"served batch {tuple(out.shape)} not finite")
    e2e_err = (out - ref).abs().max().item()
    log(f"[serve] fp32 batch vs plain versions on the card: max_abs_err "
        f"{e2e_err:.3g}; image std {out.std().item():.3f}")
    if not torch.allclose(out, ref, atol=1e-3, rtol=1e-3):
        raise AssertionError(f"served batch differs from plain: {e2e_err}")

    lat = np.asarray(latencies)
    numbers = {"single_request_ms": {
                   "n": len(lat), "p50": float(np.percentile(lat, 50)),
                   "p99": float(np.percentile(lat, 99)),
                   "mean": float(lat.mean()), "min": float(lat.min()),
                   "max": float(lat.max())},
               "e2e_max_abs_err": e2e_err,
               "profile": profile_breakdown(sampler, captions, cap_lens,
                                            noise)}
    log(f"[serve] single-request latency over {len(lat)} requests: "
        f"{json.dumps(numbers['single_request_ms'])}")
    for dtype in ("float32", "bfloat16"):
        for b in (16, 64):
            s = sampler if (dtype, b) == ("float32", 16) else \
                serve_mod.build_sampler(*args, batch_size=b, dtype=dtype)[0]
            windows = [s.throughput(n_batches=THROUGHPUT_BATCHES[b])
                       for _ in range(THROUGHPUT_WINDOWS)]
            numbers[f"img_per_s_{dtype}_bs{b}"] = windows
            log(f"[serve] Sampler.throughput {dtype} batch {b}, "
                f"{THROUGHPUT_WINDOWS} windows of {THROUGHPUT_BATCHES[b]} "
                f"batches ({THROUGHPUT_BATCHES[b] * b / min(windows):.1f} s "
                f"at most): {', '.join(f'{v:.1f}' for v in windows)} img/s")
            if (dtype, b) == ("bfloat16", 16):
                outb = s.pipeline(captions, cap_lens, noise).float()
                log(f"[serve] bf16 batch vs fp32 kernel path: max_abs_err "
                    f"{(outb - out).abs().max().item():.3g}")
            del s
    return k2, k1, numbers


def _group(name: str) -> str:
    low = name.lower()
    if "fused_modconv3x3_kernel" in name:
        return "K2 fused_modconv3x3"
    if "fused_affine_fwd_kernel" in name:
        return "K1 fused_double_affine_leaky"
    if "fused_affine_bwd" in name:
        return "K1 bwd fused_double_affine_leaky_bwd"
    if "lstm" in low or "rnn" in low:
        return "LSTM (text encoder)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach Adam, clip, EMA)"
    if "dgrad" in low:
        return "cuDNN conv dgrad"
    if "wgrad" in low:
        return "cuDNN conv wgrad"
    if "fprop" in low or "conv" in low:
        return "cuDNN conv fwd"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "copies"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM (affine MLPs, linear_in)"
    if "copy" in low or "memset" in low or "memcpy" in low:
        return "copies"
    return "other elementwise"


def _profile(fn, n: int):
    """Device time per kernel group and per kernel name over `n` calls of
    `fn`, and the device's idle share of the span from the first kernel to
    the last (torch.profiler, CUPTI). None when no device event was
    recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # device kernels and copies; user annotations (such as the optimizer's
    # "Optimizer.step#Adam.step" range) are spans, not device work
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        log("[profile] the profiler recorded no device events: device time "
            "by kernel not measured")
        return None
    groups, names = {}, {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + us
        names[e.name] = names.get(e.name, 0.0) + us
    busy = sum(groups.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    out = {"kernels_per_call": len(events) / n,
           "device_busy_ms_per_call": busy / n / 1e3,
           "span_ms_per_call": span / n / 1e3,
           "idle_share": 1.0 - busy / span,
           "ms_per_call": {k: v / n / 1e3 for k, v in
                           sorted(groups.items(), key=lambda kv: -kv[1])}}
    top = [(name, us / n / 1e3) for name, us in
           sorted(names.items(), key=lambda kv: -kv[1])[:12]]
    return out, top


def profile_breakdown(sampler, captions, cap_lens, noise, n: int = 3):
    """Device time of a served batch by kernel group, over `n` batches."""
    res = _profile(lambda: sampler.pipeline(captions, cap_lens, noise), n)
    if res is None:
        return None
    out, top = res
    out = {"batch": sampler.batch_size, "dtype": str(sampler.dtype), **out}
    log("[profile] " + json.dumps(out))
    for name, ms in top[:8]:
        log(f"[profile] {ms:8.3f} ms/batch  {name[:110]}")
    return out


def _train_setup(dtype: str):
    """Seeded full-width train state (every block gamma of G and D away
    from 0), the frozen text encoder, the step, and a seeded batch."""
    import torch

    from gan_codes_tpu_torch.config import GANConfig, TrainConfig
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.train.state import create_train_state
    from gan_codes_tpu_torch.train.step import make_train_step

    cfg = GANConfig(train=TrainConfig(batch_size=TRAIN_BATCH,
                                      compute_dtype=dtype))
    state = create_train_state(cfg, SEED, device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for module in (state.generator, state.discriminator):
            for name, p in module.named_parameters():
                if name.endswith(".gamma"):
                    p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
        for e, p in zip(state.g_ema.parameters(),
                        state.generator.parameters()):
            e.copy_(p)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        te = RNNEncoder(cfg.text_encoder)
    te = te.cuda().eval().requires_grad_(False)
    dev = torch.Generator(device="cuda").manual_seed(SEED)
    b, size = TRAIN_BATCH, cfg.generator.image_size
    images = torch.rand((b, size, size, 3), generator=dev,
                        device="cuda") * 2 - 1
    captions = torch.randint(1, cfg.text_encoder.vocab_size,
                             (b, cfg.text_encoder.max_len), generator=dev,
                             device="cuda")
    cap_lens = torch.randint(1, cfg.text_encoder.max_len + 1, (b,),
                             generator=gen)
    return cfg, state, te, make_train_step(cfg), (images, captions,
                                                   cap_lens)


def _counters():
    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    return (fused_modconv.fused_modconv3x3,
            fused_affine.fused_double_affine_leaky,
            fused_affine.fused_double_affine_leaky_bwd)


def train():
    """Phase 4. Returns (K2, K1, K1 bwd launches over the counted steps,
    train numbers)."""
    import torch

    from gan_codes_tpu_torch.train import losses

    k2, k1, k1b = _counters()
    numbers = {}
    counts = None
    for dtype in ("float32", "bfloat16"):
        cfg, state, te, step, batch = _train_setup(dtype)
        log(f"[train] {dtype}: 256px batch {TRAIN_BATCH}, G "
            f"{sum(p.numel() for p in state.generator.parameters())} and D "
            f"{sum(p.numel() for p in state.discriminator.parameters())} "
            "params")
        if dtype == "float32":
            k2.launches = k1.launches = k1b.launches = 0  # main path
            metrics = [step(state, te, *batch) for _ in range(TRAIN_STEPS)]
            counts = (k2.launches, k1.launches, k1b.launches)  # ends here
            want = (12 * TRAIN_STEPS, 14 * TRAIN_STEPS, 14 * TRAIN_STEPS)
            log(f"[train] launches over {TRAIN_STEPS} steps: K2 {counts[0]}, "
                f"K1 {counts[1]}, K1 bwd {counts[2]} (want {want})")
            if counts != want:
                raise AssertionError(f"launch counters {counts} != {want}")
        else:
            metrics = [step(state, te, *batch) for _ in range(TRAIN_STEPS)]
        rows = [{k: v.item() for k, v in m.items()} for m in metrics]
        for i, r in enumerate(rows):
            log(f"[train] {dtype} step {i}: {json.dumps(r)}")
            if not all(np.isfinite(v) for v in r.values()):
                raise AssertionError(f"non-finite metrics at step {i}: {r}")

        # throughput: two windows of >= 3 s each, CUDA events
        t0 = time.perf_counter()
        step(state, te, *batch)
        torch.cuda.synchronize()
        n = max(3, int(np.ceil(TRAIN_WINDOW_S / (time.perf_counter() - t0))))
        torch.cuda.reset_peak_memory_stats()
        windows = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                step(state, te, *batch)
            end.record()
            end.synchronize()
            windows.append(n * TRAIN_BATCH / (start.elapsed_time(end) / 1e3))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        numbers[f"img_per_s_{dtype}"] = windows
        numbers[f"peak_gib_{dtype}"] = peak
        log(f"[train] {dtype} throughput, 2 windows of {n} steps "
            f"({n * TRAIN_BATCH / min(windows):.1f} s at most): "
            f"{', '.join(f'{v:.2f}' for v in windows)} img/s; peak memory "
            f"{peak:.2f} GiB")
        res = _profile(lambda: step(state, te, *batch), 2)
        if res is not None:
            out, top = res
            out = {"batch": TRAIN_BATCH, "dtype": dtype, **out}
            numbers[f"profile_{dtype}"] = out
            log("[profile] train step " + json.dumps(out))
            for name, ms in top:
                log(f"[profile] {ms:8.3f} ms/step  {name[:110]}")
        del state, step

    # (a) phase 3 alone against one D: G forward + backward (the kernels'
    # backward) from one state, through the kernels and through the plain
    # versions; (b) one whole fp32 step from one state each way
    cfg, state, te, step, (images, captions, cap_lens) = _train_setup(
        "float32")
    noise = torch.randn((TRAIN_BATCH, cfg.generator.latent_dim),
                        generator=torch.Generator(device="cuda"
                                                  ).manual_seed(SEED),
                        device="cuda")
    numbers["phase_ms"] = _phase_times(state, te, images, captions,
                                       cap_lens, noise, cfg.loss)
    log(f"[train] fp32 device ms by phase (CUDA events, 3 calls each): "
        f"{json.dumps(numbers['phase_ms'])}")
    g_params = list(state.generator.named_parameters())

    def phase3_grads():
        with torch.no_grad():
            sents = te(captions, cap_lens).float()
        fake = state.generator(noise, sents)
        loss = losses.g_hinge_loss(state.discriminator, fake, sents)
        return dict(zip((n for n, _ in g_params), torch.autograd.grad(
            loss, [p for _, p in g_params])))

    grads = [_plain_or_kernels(plain, phase3_grads) for plain in (False,
                                                                  True)]
    one_d = _grad_gap(*grads)
    log(f"[train] phase-3 G gradients against one D, kernels vs plain "
        f"versions: {_gap_text(one_d)}")
    if one_d["max_err"] > 1e-3 * one_d["max_ref"]:
        raise AssertionError(f"phase-3 G gradients against one D: {one_d}")
    del state, step, grads

    results = []
    for plain in (False, True):
        cfg, state, te, step, batch = _train_setup("float32")
        m = _plain_or_kernels(plain, lambda: step(state, te, *batch,
                                                  noise=noise))
        results.append(({k: v.item() for k, v in m.items()},
                        {name: p.grad.detach().clone() for name, p in
                         state.generator.named_parameters()}))
        del state, step
    (m_k, g_k), (m_p, g_p) = results
    for key in ("d_loss", "d_gp_loss", "g_loss"):
        if not np.isclose(m_k[key], m_p[key], rtol=1e-4, atol=0.0):
            raise AssertionError(f"{key}: kernels {m_k[key]} plain "
                                 f"{m_p[key]}")
    step_gap = _grad_gap(g_k, g_p)
    log(f"[train] one fp32 step, kernels vs plain versions: losses "
        f"{json.dumps(m_k)} vs {json.dumps(m_p)}; phase-3 G gradients: "
        f"{_gap_text(step_gap)}")
    if step_gap["max_err"] > 1e-3 * step_gap["max_ref"]:
        raise AssertionError(f"phase-3 G gradients of one step: {step_gap}")
    numbers["vs_plain"] = {"kernels": m_k, "plain": m_p,
                           "step_g_grads": step_gap, "one_d_g_grads": one_d}
    return counts, numbers


def _grad_gap(got: dict, want: dict) -> dict:
    """max|err| over all gradients against the largest |ref| among them,
    and the tensor whose own max|err| / max|ref| is largest."""
    errs = {n: (got[n] - want[n]).abs().max().item() for n in want}
    tops = {n: want[n].abs().max().item() for n in want}
    worst = max(want, key=lambda n: errs[n] / max(tops[n], 1e-30))
    return {"max_err": max(errs.values()), "max_ref": max(tops.values()),
            "worst_tensor": worst,
            "worst_tensor_ratio": errs[worst] / max(tops[worst], 1e-30)}


def _gap_text(gap: dict) -> str:
    return (f"max|err| {gap['max_err']:.3g} against max|ref| "
            f"{gap['max_ref']:.3g} ({gap['max_err'] / gap['max_ref']:.3g}); "
            f"largest per-tensor ratio {gap['worst_tensor_ratio']:.3g} "
            f"({gap['worst_tensor']})")


def _plain_or_kernels(plain: bool, fn):
    """fn() with the DFBlocks dispatched to the kernels, or to the plain
    versions (patched as for the served batch); the plain run must launch
    no kernel."""
    from unittest import mock

    from gan_codes_tpu_torch.ops import blocks, fusion
    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    counters = _counters()
    with mock.patch.object(
            blocks, "fused_modconv3x3",
            fused_modconv.reference_modconv3x3 if plain
            else fused_modconv.fused_modconv3x3), \
            mock.patch.object(
                fusion, "fused_double_affine_leaky",
                fused_affine.reference_double_affine_leaky if plain
                else fused_affine.fused_double_affine_leaky):
        before = [c.launches for c in counters]
        out = fn()
        if plain and [c.launches for c in counters] != before:
            raise AssertionError("the plain versions launched a kernel")
    return out


def _phase_times(state, te, images, captions, cap_lens, noise, loss_cfg):
    """Device ms of each part of an fp32 step, apart (CUDA events, after a
    warm call): the G forward + backward, the phase-1 D hinge gradient, the
    phase-2 MA-GP gradient (double backward), and phase 3's D forward +
    input gradient. D is not updated."""
    import torch

    from gan_codes_tpu_torch.train import losses

    g, d = state.generator, state.discriminator
    with torch.no_grad():
        sents = te(captions, cap_lens).float()
    fake = g(noise, sents).detach()
    d_params, g_params = list(d.parameters()), list(g.parameters())

    def g_fwd_bwd():
        out = g(noise, sents)
        torch.autograd.grad(out, g_params, torch.ones_like(out))

    def phase1():
        torch.autograd.grad(losses.d_hinge_loss(d, images, fake, sents),
                            d_params)

    def phase2():
        torch.autograd.grad(
            losses.ma_gradient_penalty(d, images, sents, loss_cfg),
            d_params, allow_unused=True)

    def phase3_d():
        f = fake.detach().requires_grad_(True)
        torch.autograd.grad(losses.g_hinge_loss(d, f, sents), f)

    return {name: cuda_ms(fn, 3) for name, fn in (
        ("g_fwd_bwd", g_fwd_bwd), ("phase1_d_hinge", phase1),
        ("phase2_ma_gp", phase2), ("phase3_d", phase3_d))}


def _snapshot(obj):
    """A CPU copy of a nested dict / list of tensors and plain values."""
    import torch

    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    return obj


def _bit_equal(a, b, path: str = "state") -> int:
    """Raise unless a and b (from `_snapshot`) are equal bit for bit;
    returns the number of tensors compared."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys differ")
        return sum(_bit_equal(a[k], b[k], f"{path}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        return sum(_bit_equal(x, y, f"{path}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{path}: tensors differ")
        return 1
    if a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")
    return 0


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def train_entry_phase(root: str, bare_img_s: float):
    """Phase 5. Returns (K2, K1, K1 bwd launches over the three
    `train_entry.train` calls, train-entry numbers)."""
    import contextlib
    from unittest import mock

    import torch
    from PIL import Image

    from gan_codes_tpu_torch import serve as serve_mod
    from gan_codes_tpu_torch import train_entry
    from gan_codes_tpu_torch.config import GANConfig
    from gan_codes_tpu_torch.data.synthetic import make_synthetic_cub
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.ops.kernels import fused_modconv
    from gan_codes_tpu_torch.train.checkpoint import state_to_dict
    from gan_codes_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    data = os.path.join(root, "cub")
    info = make_synthetic_cub(data, n_train=ENTRY_TRAIN, n_test=ENTRY_TEST,
                              image_size=256, seed=SEED)
    cfg = GANConfig.for_image_size(256, vocab_size=info["n_words"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        te = RNNEncoder(cfg.text_encoder)
    te_path = os.path.join(root, "entry_text_encoder.pth")
    torch.save(te.state_dict(), te_path)
    log(f"[entry] synthetic CUB {ENTRY_TRAIN} + {ENTRY_TEST} images and a "
        f"text encoder in {time.perf_counter() - t0:.2f}s")

    class Recorded(Trainer):
        """The Trainer, keeping each instance and a snapshot of its state
        as the first epoch starts (after any restore)."""
        made = []

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.at_start = None
            Recorded.made.append(self)

        def train_epoch(self, loader):
            if self.at_start is None:
                self.at_start = _snapshot(state_to_dict(self.state))
            return super().train_epoch(loader)

    k2, k1, k1b = _counters()
    steps_per_epoch = ENTRY_TRAIN // TRAIN_BATCH

    def run(name: str, epochs: int):
        kw = dict(image_size=256, batch_size=TRAIN_BATCH, num_epochs=epochs,
                  seed=SEED, n_channels=32, compute_dtype="float32",
                  device="cuda")
        tee = _Tee(sys.stdout)
        k2.launches = k1.launches = k1b.launches = 0  # main path starts
        t = time.perf_counter()
        with mock.patch.object(train_entry, "Trainer", Recorded), \
                contextlib.redirect_stdout(tee):
            hist = train_entry.train(data, te_path,
                                     os.path.join(root, f"{name}_images"),
                                     os.path.join(root, f"{name}_weights"),
                                     **kw)
        wall = time.perf_counter() - t
        counts = (k2.launches, k1.launches, k1b.launches)  # ends here
        return hist, counts, wall, tee.buf.getvalue(), Recorded.made[-1]

    hist_a, counts_a, wall_a, _, tr_a = run("a", 2)
    hist_b1, counts_b1, wall_b1, _, tr_b1 = run("b", 1)
    saved_b = _snapshot(state_to_dict(tr_b1.state))
    hist_b2, counts_b2, wall_b2, out_b2, tr_b2 = run("b", 2)

    # counters: per step one K2 per DFBlock K2 takes, one K1 and one K1
    # bwd per DFBlock (12, 14, 14 at 256px); per eval batch (one test
    # batch each epoch) a generator forward (12 K2, 2 K1 at 256px)
    shapes = dfblock_shapes(tr_a.cfg.generator)
    n_k2 = sum(fused_modconv._supported(
        torch.empty(3, 3, cin, cout, device="meta")) for _, cin, cout in shapes)
    n_df = len(shapes)
    totals = [0, 0, 0]
    for counts, epochs in ((counts_a, 2), (counts_b1, 1), (counts_b2, 1)):
        steps = epochs * steps_per_epoch
        want = (n_k2 * (steps + epochs), n_df * steps + (n_df - n_k2) * epochs,
                n_df * steps)
        if counts != want:
            raise AssertionError(f"train-entry launch counters {counts} != "
                                 f"{want} ({steps} steps, {epochs} evals)")
        totals = [t + c for t, c in zip(totals, counts)]
    log(f"[entry] launches (K2, K1, K1 bwd): run A {counts_a}, run B "
        f"{counts_b1} then {counts_b2}")

    if "Resuming from epoch 1" not in out_b2:
        raise AssertionError("run B's second call did not resume from "
                             "epoch 1")
    n_tensors = _bit_equal(tr_b2.at_start, saved_b)
    log(f"[entry] run B restored its saved state bit for bit: step "
        f"{saved_b['step']}, {n_tensors} tensors (G, D, EMA, both Adam "
        f"states, RNG)")
    gaps = {}
    for key in ("g_losses", "d_losses", "d_gp_losses", "txtimg_losses"):
        a, b = hist_a[key][1], hist_b2[key][1]
        gaps[key] = abs(a - b) / max(abs(a), 1e-30)
        if not np.isclose(b, a, rtol=1e-3, atol=0.0):
            raise AssertionError(f"epoch 2 {key}: run A {a}, resumed run B "
                                 f"{b}")
        if not (np.isfinite(a) and np.isfinite(b)):
            raise AssertionError(f"epoch 2 {key} not finite: {a} {b}")
    log(f"[entry] epoch 2, resumed B against uninterrupted A: relative gaps "
        f"{json.dumps(gaps)}; A {json.dumps({k: v[1] for k, v in hist_a.items()})}")
    for name in ("a", "b"):
        wdir = os.path.join(root, f"{name}_weights")
        for f in ("histories.json", "metrics_log.jsonl", "config.json",
                  "checkpoint", "gen_1.pth", "gen_ema_1.pth"):
            if not os.path.exists(os.path.join(wdir, f)):
                raise AssertionError(f"run {name}: {f} missing")
        with open(os.path.join(wdir, "metrics_log.jsonl")) as f:
            epochs = [json.loads(line)["epoch"] for line in f]
        if epochs != [0, 1]:
            raise AssertionError(f"run {name}: metrics rows {epochs}")
        grid = os.path.join(root, f"{name}_images", "fake_sample_epoch_1.png")
        if not os.path.exists(grid):
            raise AssertionError(f"run {name}: sample grid missing")
    grid_px = Image.open(grid).size
    log(f"[entry] files present in both runs; grid {grid_px} px; figure "
        f"{'written' if os.path.exists(os.path.join(root, 'b_images', 'samples_with_text_epoch_1.jpg')) else 'not written'}")

    # the trained gen_1.pth serves one request over HTTP on the card
    sampler, epoch = serve_mod.build_sampler(
        data, te_path, os.path.join(root, "b_weights"), batch_size=4)
    server = serve_mod.make_http_server(sampler, port=0, epoch=epoch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        code, body = post(f"http://127.0.0.1:{server.server_address[1]}",
                          {"prompts": ["this bird has a red crown"]})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        body["images"][0]))))
    size = tr_a.cfg.generator.image_size
    if code != 200 or epoch != 1 or img.shape != (size, size, 3):
        raise AssertionError(f"serving gen_{epoch}.pth: {code} {img.shape}")
    log(f"[entry] build_sampler served gen_{epoch}.pth: one {size}px PNG, "
        f"pixel std {img.std():.2f}")

    numbers = {}
    for name, tr, wall, epochs in (("A", tr_a, wall_a, 2),
                                   ("B2", tr_b2, wall_b2, 1)):
        steps = epochs * steps_per_epoch
        step_s = tr.timers["step"].total()
        h2d_s = tr.timers["h2d"].total()
        hs = tr.host_seconds
        numbers[name] = {
            "steps": steps, "call_s": wall,
            "img_per_s_train_epoch": steps * TRAIN_BATCH / hs["train"],
            "img_per_s_call": steps * TRAIN_BATCH / wall,
            "step_device_ms": [t * 1e3 for t in tr.timers["step"].times],
            "h2d_device_ms_total": h2d_s * 1e3,
            "host_s": dict(hs), "step_device_s_total": step_s}
        log(f"[entry] run {name}: {steps} steps, {epochs} epochs; trainer "
            f"{numbers[name]['img_per_s_train_epoch']:.2f} img/s over "
            f"train_epoch ({hs['train']:.3f}s: data wait "
            f"{hs['data_wait']:.3f}s, H2D copies {h2d_s * 1e3:.2f} ms "
            f"device, steps {step_s:.3f}s device {['%.1f' % (t * 1e3) for t in tr.timers['step'].times]} ms); "
            f"eval + sample dumps {hs['eval']:.3f}s, checkpoints "
            f"{hs['checkpoint']:.3f}s; whole call {wall:.2f}s = "
            f"{numbers[name]['img_per_s_call']:.2f} img/s; bare step "
            f"(phase 4) {bare_img_s:.2f} img/s")
    return tuple(totals), numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gan_codes_tpu_torch.config import GeneratorConfig
    from gan_codes_tpu_torch.ops.kernels import _build
    from gan_codes_tpu_torch.utils.device import serving_device

    serving_device("cuda")  # TF32 off for the fp32 plain versions too
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] one nvcc call, sm_90a, {len(_build.SOURCES)} sources -> "
        f"{_build.library_path().name}: {time.perf_counter() - t0:.2f}s")
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    summary, k2_n, k1_n = check_kernels(GeneratorConfig())
    summary["fused_resblock_g"], k3_checks = check_resblock(GeneratorConfig())
    log(f"[kernels] phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="smoke_") as root:
        os.makedirs(os.path.join(root, "weights"))
        os.makedirs(os.path.join(root, "data"))
        write_weights(root)
        k2, k1, numbers = serve(root, k2_n, k1_n)
    log("[serve] " + json.dumps(numbers))
    log(f"[serve] phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    (t_k2, t_k1, t_k1b), train_numbers = train()
    log("[train] " + json.dumps(train_numbers))
    log(f"[train] phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="entry_") as root:
        (e_k2, e_k1, e_k1b), entry_numbers = train_entry_phase(
            root, min(train_numbers["img_per_s_float32"]))
    log("[entry] " + json.dumps(entry_numbers))
    log(f"[entry] phase took {time.perf_counter() - t0:.1f}s")
    # launches on the main paths; K3 is on none (as in the JAX package),
    # so its only launches are the kernel checks', which do not count
    launches = {"fused_modconv3x3": {"serve": k2, "train": t_k2,
                                     "train_entry": e_k2},
                "fused_double_affine_leaky": {"serve": k1, "train": t_k1,
                                              "train_entry": e_k1},
                "fused_double_affine_leaky_bwd": {"serve": 0,
                                                  "train": t_k1b,
                                                  "train_entry": e_k1b},
                "fused_resblock_g": {"serve": 0, "train": 0,
                                     "train_entry": 0}}
    kernels = []
    for name, s in summary.items():
        by_path = dict(launches[name])
        entry = {"name": name, "route": s["route"], "source": s["source"],
                 "replaces": s["replaces"],
                 "launches": sum(by_path.values()),
                 "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                 "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                 "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                 "launches_by_path": by_path, "dtype": "float32",
                 "batch": KERNEL_BATCH, "ms_per": s["per"],
                 "shapes_per_call": s["path_shapes"]}
        if name == "fused_resblock_g":
            by_path["kernel_checks"] = k3_checks
        for extra in ("bwd_ms", "plain_bwd_ms", "ms_per_train_step",
                      "composition_ms", "bf16_ms", "bf16_composition_ms",
                      "bf16_bound_ms"):
            if extra in s:
                entry[extra] = s[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card checks of the PyTorch/CUDA port (`gan_codes_tpu_torch`) on one
GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It checks; it measures nothing. `h100_bench/` measures the port end to
end and per layer, and `gan_codes_tpu_torch/tools/kernel_ab.py` times each
kernel alone.

Phases (any failed check raises, so the run exits non-zero):

1. Build: compiles every kernel source in `gan_codes_tpu_torch/csrc/` for
   sm_90a, one nvcc per source started together, then links them into one
   library; prints the card's name and power limit.
2. Kernels: calls each kernel's wrapper on the card at the shapes the main
   paths give it (batch 8): K2 at every DFBlock its `_supported` takes (all
   14 of the 256px generator), K1 and K1 bwd at the input of every DFBlock
   of a train step (14 DFBlocks, 10 distinct shapes; K2's backward runs K1
   bwd with z, which gives h for the weight gradient; the served forward
   runs K1 on the DFBlocks K2 declines, none at 256px), in float32 with
   TF32 off and in bfloat16, and holds each result against the kernel's
   plain PyTorch version on the same inputs, K2's and K1 bwd's also
   against a second call bit for bit, K1 bwd's also against the call
   without z, and K1 bwd's z against K1's output bit for bit. K3
   (`fused_resblock_g`, on no model path) runs at the 7 residual-block
   shapes of the 256px generator, batch 8, in both dtypes, against its
   plain version and a second call bit for bit, and its backward (fp32)
   against the plain composition's autograd.
3. Serve: writes seeded random full-width weights (256px, n_channels=32,
   vocab 5450, embed 300, hidden 256, every block gamma != 0) as
   reference-format `gen_1.pth` + `text_encoder.pth` + `captions.pickle`,
   builds the sampler with `build_sampler`, serves it with
   `make_http_server` on 127.0.0.1, and drives POST /generate (prompts and
   captions, PNG and JPEG, then SINGLE_REQUESTS single-prompt requests one
   at a time), /healthz and /metrics (the request and image counts). The
   kernels' launch counters are set to 0 just before the requests and
   must rise by exactly their share of 14 DFBlocks per dispatched batch.
   One batch with explicit noise is held against the same forward through
   the plain versions on the card; the same batch through a bfloat16
   sampler prints its gap to it, and that sampler's `throughput` runs two
   batches (its card-only branch; the rate is not read).
3b. Serving, the rest (phase 3's weights dir and fp32 sampler, batch 16,
   TF32 off): writes seeded `gen_2.pth`, `gen_ema_1.pth`, `gen_ema_2.pth`
   (to a temporary name, then renamed, as the trainer writes). (a)
   `build_sampler(use_ema=True)` serves `gen_ema_2.pth`: a batch with
   explicit noise equals a sampler built on that file bit for bit. (b)
   `POST /reload` while a client thread sends one-prompt requests (every
   one must answer 200): `{}` moves to epoch 2, `{"epoch": 1}` pins epoch
   1; after each, a batch equals a sampler on that epoch's file bit for
   bit, /healthz shows the epoch and `pinned`, /metrics `reloads_total`.
   (c) `--watch` (WATCH_S): a new `gen_3.pth` is served within 10 s, then
   a pin on epoch 3 holds against a newer `gen_4.pth` for 1 s. (d) BURST
   one-prompt requests at once, coalesced (`--coalesce-ms` COALESCE_S) and
   not: all 200, at most 4 coalesced dispatches, K2 (K1) rising by exactly
   its share of 14 a dispatch. (e) Data-parallel serving:
   `Sampler(devices=[cuda:0, cuda:0])` and the CLI's `--dp` (every card,
   [cuda:0] here) against the plain sampler with the same seed over 20
   rows (2 batches): allclose(1e-4, 1e-4), K2 rising by 14 per replica per
   batch; `throughput` runs two batches on the plain and the two-replica
   sampler (the rate is not read); `serve.main(data_parallel=True)` end to
   end.
4. Train: builds seeded full-width train states (G 256px n_channels 32,
   D n_channels 32, every block gamma != 0) with `create_train_state`, a
   seeded text encoder and a seeded batch of TRAIN_BATCH images in [-1, 1]
   and random captions, and runs `make_train_step`'s 3-phase step:
   TRAIN_STEPS steps in float32 (TF32 off) with the launch counters set to
   0 just before and read just after (14 K2, 0 K1, 14 K1 bwd per step;
   19 MA-GP weight terms per step, `PenaltyConv2d.weight_terms`; every
   step after the first a CUDA graph replay, `step.replays`), then in
   bfloat16; every metric must be finite. From one fp32 state, held
   against the same through the plain versions: the phase-3 G gradients
   against one D; one whole step, D learning (its losses, its phase-1 D
   gradients and its G gradients); the phase-3 G gradients against the D
   that step left through the kernels. Runs REPEAT_STEPS fp32 steps twice
   from one state on cuDNN's default and on its deterministic algorithms:
   the deterministic runs must leave every parameter equal bit for bit
   (the default runs' count is printed).
5. Train entry: writes a synthetic CUB fixture (`make_synthetic_cub`,
   48 train and 24 test images of 256-511 px), a seeded text encoder and
   a seeded random InceptionV3 `.pth` in torchvision's layout (the keys of
   the port's `_conv_specs`, random BN running stats), then runs
   `train_entry.train` with that `.pth` at full width (256px, n_channels
   32, batch 24, fp32, 2 steps per epoch, `deterministic`: cuDNN's
   deterministic algorithms): run A, 2 epochs uninterrupted;
   run B, 1 epoch, then a second call with 2 epochs on the same
   directories, which must print "Resuming from epoch 1". Holds: the
   state B's second call restored equals the state B saved, bit for bit
   (parameters, EMA, Adam moments, step, RNG); B's second-epoch losses,
   IS and FID equal to A's bit for bit (with cuDNN's default algorithms
   the runs drift apart from the last bit, and the resumed losses have
   differed from A's by 5%); the checkpoint files, one metrics row per
   epoch with a finite IS > 1 and a finite FID (not the sentinels 1.0 and
   inf), and the sample grid; the launch counters rise by 14 K2, 0 K1 and
   14 K1 bwd per step plus 14 K2 and 0 K1 per eval batch; `build_sampler`
   serves B's `gen_1.pth` over HTTP.
6. Eval: the reference's per-epoch protocol at full width, EVAL_BATCHES
   batches of 24 = 768 images a side: fakes from the 256px G (n_channels
   32, every block gamma != 0) on seeded random captions, seeded 256px
   uint8 reals, the phase-5 Inception `.pth` through
   `load_torch_inception`, fp32 with TF32 off. With the launch counters
   set to 0 just before, `Trainer.evaluate` runs twice on a deterministic
   loader (the first computes the real side, the second reads it from the
   cache; 14 K2 and 0 K1 per eval batch); both give a finite IS > 1 and
   FID, and the same scores within the card-against-CPU limits, as does
   the same evaluation in parts (G fakes, Inception on each side, the
   host's IS/FID math). Holds the card against the CPU: the features and
   softmax of 8 images, and IS/FID over EVAL_SUBSET images a side (the
   low-rank cross term taken on both).
7. Data parallelism (`gan_codes_tpu_torch/parallel/`). (a) The production
   path at world size 1 over NCCL: `train_entry --dp` in a child process
   (this script with `--dp-entry-child`) with a torchrun environment
   (RANK 0, WORLD_SIZE 1), on phase 5's data, text encoder and Inception
   `.pth` with run A's flags (256px, n_channels 32, batch 24, fp32 with
   TF32 off, deterministic cuDNN, 2 epochs). Holds: its losses within
   rtol 1e-3 and its IS - 1 and FID within ENTRY_IS_RTOL and
   ENTRY_FID_RTOL of run A's (the same data, seed and flags in another
   process), the launch counters (14 K2, 0 K1 and 14 K1 bwd a step, 14 K2
   an eval batch), and the collectives the parallel module counted: 4
   all-reduces a step (the next rank's sentence, then phase 1's, phase 2's
   and phase 3's gradients with their losses) and 1 in `replicate`. (b)
   Two ranks on the one card over gloo (NCCL refuses two ranks on one
   device), `gan_codes_tpu_torch/tools/dp_check.py`: one step from one
   state at 256px, local batch 12 + 12, against the single-process step
   on the global batch of 24 (the same noise rows, drawn at the global
   batch): d_loss within rtol 1e-4, the reduced phase-1 D and phase-3 G
   gradients within 1e-3 of max|ref|, the ranks' states equal bit for
   bit; the moment-reduced IS/FID over 2 x 24 fakes against
   `compute_is_fid` on the 48 (IS - 1 within 1e-2, FID within 1e-5,
   relative).
8. Interop (`models/torch_import.py`): a full-width fp32 state after 2
   train steps on a seeded batch, saved as the reference's `checkpoint.pt`
   (its state_dicts in the reference's key order, each block's gamma
   last; both Adam states keyed by that order, with no entry for one D
   parameter; numpy-free histories of epoch 0), imported by `python -m
   gan_codes_tpu_torch.models.torch_import --ckpt` in a process of its
   own. Holds the imported `checkpoint` against the source bit for bit
   (G, D, the EMA as G, every exp_avg and exp_avg_sq by name, zeros for
   the parameter without an entry, each step, the step 2). Then
   `train_entry.train` on phase 5's data resumes it for one more epoch
   ("Resuming from epoch 1", finite losses, launch counters 14 K2, 0 K1
   and 14 K1 bwd a step plus 14 K2 for the eval batch), `--export` writes
   its `gen_1.pth` back (equal to the weights dir's bit for bit) and
   `build_sampler` serves one request from the export over HTTP.
9. The rest of the port, at full width (the 256px generator, n_channels
   32, every block gamma != 0). (a) `ops/blocks.py::res_block_g_up` at
   the six up-blocks, batch 8, fp32 (TF32 off) and bf16: against
   `res_block_g(upsample_nearest_2x(x))` on the card (cuDNN's conv_1
   against K2's: fp32 allclose(2e-4, 2e-4), bf16 max|err| <= 2^-5 *
   max|ref|) and against its plain versions (the same limits); its fp32
   backward against the plain composition's autograd (<= 1e-3 of
   max|ref| per input); launches exactly what the code launches (a
   forward 1 K1 at low res and K2 for DFBlock-2 where `_supported` takes
   it, else a second K1; a backward 2 K1 bwd). (b)
   `ops/nn.py::conv3x3_on_upsampled` at the six conv_1 shapes, fp32,
   against `conv2d(upsample_nearest_2x(x))`: allclose(1e-4, 1e-4).
   (c) `examples/train_example.py` at 256px, batch 24, on its synthetic
   fixture of ENTRY_TRAIN + ENTRY_TEST images, 2 epochs (K2 and K1 bwd
   on 14 DFBlocks a step, K2 14 an eval batch), then `eval_example.py` on
   its weights dir (14 K2 a sampled batch: the test batch and the
   caption's); the PNGs exist at 256px. (d) `tools/validate_pretrained.py
   --self-test` (its assets under this run's directory) and
   `--check-weights` on (c)'s weights dir (14 K2), both exit 0; their
   [PASS] lines carry the deltas. (e) `tools/longrun.py` at 256px, batch
   24, on (c)'s fixture, LONGRUN_EPOCHS epochs with a SIGKILL after epoch
   LONGRUN_KILL (train_entry in child processes, `--deterministic`, each
   within LEG_TIMEOUT_S; their launches are not counted here): the
   resumed run equals its twin bit for bit, its losses in band.
10. The last trainer options, at full width (256px, n_channels 32). (a)
   K2 at the 14 DFBlocks and K3 at the 7 blocks, batch 8, fp32, in one
   TF32 pass (the process's precision "high") and in 3xTF32 ("highest")
   on the same inputs: the one-pass call against its plain version of
   that mode (both conv operands rounded to TF32; K2 allclose 1e-4, K3
   2e-4, the 3xTF32 tolerances, as the products are exact) and a second
   call bit for bit; each mode's drift from the float64 plain version
   (one pass at least MODE_DRIFT_RATIO = 10 times 3xTF32's, which a
   kernel that ignored its mode would not show). (b) One fp32 step at
   batch 24 at "high" against one at "highest" from one state: its losses
   and G and phase-1 D gradients (tolerances at TF32_STEP_TOL). (c) The
   step with and without `remat_blocks` (`--remat-g`), fp32 batch 24,
   bf16 batch 24 and 128, from one state on deterministic cuDNN: the
   gradients bit for bit, the launches (K2, K1, K1 bwd: 28, 0, 14 with
   remat, 14, 0, 14 without). (d) `train_entry.train` at 256px, batch 24,
   on a synthetic CUB fixture with `matmul_precision="high"`, `remat_g`,
   `device_prefetch` and `deterministic`: run A 2 epochs, run B 1 and
   resumed to 2 (equal to A bit for bit at epoch 2), run C as B's first
   epoch with the uploads on the step's stream (equal to it bit for
   bit), the launch counters of each run, and the profiler over A's first
   epoch: the batches' host-to-device copies on a stream that runs none
   of K2's launches. (e) A NaN in a G weight, then in a D weight, under
   `debug_nans`: each step raises FloatingPointError naming its phase (the
   G forward, phase 1).
11. Prints one {"kernels": [...]} line (each kernel's route, source, the
   Pallas call it replaces, its launches by path, its phase-2 errors and,
   for K2 and K3, phase 10's one-pass error and drifts), the nvidia-smi
   line, and, last,
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
SINGLE_REQUESTS = 4             # single-prompt HTTP requests, one at a time
TRAIN_BATCH = 24                 # the JAX package's TrainConfig default
TRAIN_STEPS = 3                  # counted steps per dtype (main path)
REPEAT_STEPS = 2                 # steps a run of the repeatability check
ENTRY_TRAIN, ENTRY_TEST = 48, 24  # synthetic CUB images for the train entry
ENTRY_IS_RTOL = 2e-2             # phase 7a's IS - 1 against run A's
ENTRY_FID_RTOL = 5e-6            # and its FID
EVAL_BATCHES = 32                # the reference's eval_max_batches (x 24)
EVAL_SUBSET = 48                 # images a side, IS/FID card against CPU
EVAL_IS_RTOL = 1e-2              # IS - 1, card against CPU
EVAL_FID_RTOL = 1e-5             # FID, card against CPU
# tolerances of the kernel checks (phase 2), each against the plain version
# on the same inputs:
#   K1 only rounds where the plain version rounds (no reduction): fp32
#   allclose(1e-6, 1e-6); bf16 max|err| <= 2^-7 * max|ref| (two ulps).
#   K2 sums 9*Cin products in another order than cuDNN (fp32 as 3xTF32,
#   about 2^-22 relative per product): fp32 allclose(1e-4, 1e-4) with TF32
#   off; bf16 rounds the sum to bf16 before the bias add, as the plain
#   version does, so one-ulp flips of the rounded sum are expected:
#   max|err| <= 2^-6 * max|ref|. A second call equals the first bit for
#   bit (split K adds its partial sums in a fixed order).
#   K1 bwd (one launch; with z where K2's backward asks): dx rounds where
#   the plain version rounds: fp32 allclose(1e-6), bf16 max|err| <= 2^-7 *
#   max|ref|; dg1/db1/dg2/db2 add H*W products in another order (pairs
#   of pixels in fp32, then fp64: a tree in each block, the cluster's
#   blocks in rank order): fp32 allclose(1e-4), bf16 <= 2^-6 * max|ref|;
#   a second call, and the call without z, equal it bit for bit; z equals
#   K1's output bit for bit.
#   K3 chains two convs, each summed in another order than cuDNN (fp32 as
#   3xTF32): fp32 allclose(2e-4, 2e-4); bf16 rounds h1 and h2 to bf16, so
#   each conv may flip one ulp: max|err| <= 2^-5 * max|ref|. A second call
#   equals the first bit for bit (no atomics). Its backward (fp32) against
#   the plain composition's autograd: max|err| <= 1e-3 * max|ref| per input.
#   The served image (phase 3, fp32) passes 14 DFBlocks, each reordered:
#   allclose(1e-3, 1e-3). Phase 3b: the same weights, tokens and noise
#   through the same kernels give the same batch bit for bit (--ema, after
#   each reload); a data-parallel replica computes a block of 8 rows where
#   the plain sampler computes 16, and cuDNN and cuBLAS may pick other
#   algorithms for 8: allclose(1e-4, 1e-4).
#   Train (phase 4, fp32), kernels against the plain versions from one
#   state: the phase-3 G gradients against one D; in one whole step (D
#   learning) its G gradients and its phase-1 D gradients; the phase-3 G
#   gradients against the D that step left; each max|err| <= 1e-3 *
#   max|ref| over all of them (the convs' sums are reordered; a scalar
#   such as a block gamma sums 10^7 products that cancel, so a per-tensor
#   ratio is printed, not held); the step's d_loss, d_gp_loss, g_loss
#   rtol 1e-4. Adam with beta1 = 0 turns a D gradient within rounding of
#   zero into +-lr, so D's parameters after the step are not compared.
#   H100 readings (PR 7): D gradients 7.9e-6, the step's G gradients
#   8.8e-6 to 3.6e-5; d_gp_loss 6.1e-8 to 8.5e-7, g_loss 1.7e-7 to
#   1.5e-5 (3 D elements flipped in every process).
#   Eval (phase 6), the card against the CPU, both fp32 (TF32 off on the
#   card): InceptionV3's pool features atol 2e-4 / rtol 1e-3 and its
#   softmax atol 1e-4 (tests/test_metrics.py's oracle tolerances: cuDNN
#   and the CPU sum each conv in other orders); over EVAL_SUBSET images a
#   side, IS - 1 within EVAL_IS_RTOL and FID within EVAL_FID_RTOL (the
#   features' gaps, through the low-rank cross term). IS is held as IS - 1:
#   random Inception weights give IS about 1 + 1.5e-4, and one float32 ulp
#   of IS is 8e-4 of that. H100 readings (PR 7): IS - 1 gap 0, FID
#   5.7e-7 to 5.9e-7; the same limits hold a second evaluation (real side
#   cached) and the evaluation in parts against the first (readings 0).
#   Phase 7a's DP run scores its epochs with IS - 1 within ENTRY_IS_RTOL
#   and FID within ENTRY_FID_RTOL of phase 5's run A (its G differs as its
#   losses do, by the rounding of the DP forms' sums; before phase 5 ran
#   on cuDNN's deterministic algorithms, the resumed run B's readings
#   against A: IS 0 to 2 ulps, 1.6e-3 of IS - 1; FID 7.4e-8 to 2.9e-7).
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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

    from gan_codes_tpu_torch.ops.kernels import fused_modconv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B = KERNEL_BATCH
    shapes = dfblock_shapes(gcfg)
    k2_shapes = [s for s in shapes if fused_modconv._supported(
        torch.empty(3, 3, s[1], s[2], device="meta"))]
    k1_path = [(s[0], s[1]) for s in shapes if s not in k2_shapes]
    # a train step runs K1 bwd at every DFBlock input (inside K2's
    # backward, with z; in K1's own backward on the K2 declines), and K1's
    # forward only on the K2 declines
    k1_step = [(s[0], s[1]) for s in shapes]
    summary = {
        "fused_modconv3x3": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_modconv.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_modconv.py:118",
            max_abs_err=0.0, bf16_max_abs_err=0.0),
        "fused_double_affine_leaky": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_affine.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_affine.py:71",
            max_abs_err=0.0),
        "fused_double_affine_leaky_bwd": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_affine.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_affine.py:133",
            max_abs_err=0.0),
    }
    log(f"[kernels] per forward: K2 takes {len(k2_shapes)} DFBlocks "
        f"{k2_shapes}, K1 takes {len(k1_path)} {k1_path}; per train step "
        f"K1 bwd takes all {len(k1_step)}")

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale
                ).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
        for (hw, cin, cout) in k2_shapes:
            x = rand(B, hw, hw, cin, dtype=dtype)
            g1, b1, g2, b2 = (rand(B, cin, dtype=dtype) for _ in range(4))
            w = rand(3, 3, cin, cout, dtype=dtype, scale=(9 * cin) ** -0.5)
            bias = rand(cout, dtype=dtype, scale=0.1)
            args = (x, g1, b1, g2, b2, w, bias)
            out = fused_modconv.fused_modconv3x3(*args)
            again = fused_modconv.fused_modconv3x3(*args)
            ref = fused_modconv.reference_modconv3x3(*args)
            torch.cuda.synchronize()
            err = _held(f"K2 {name} {(B, hw, hw, cin, cout)}", out, ref,
                        fp32, 1e-4, -6)
            if not torch.equal(out, again):
                raise AssertionError(f"K2 {name} {(B, hw, hw, cin, cout)}: "
                                     "a second call differs")
            top = ref.float().abs().max().item()
            log(f"[kernels] K2 {name} x[{B},{hw},{hw},{cin}] -> {cout}: "
                f"max_abs_err {err:.3g} max_rel_err {err / top:.3g}, second "
                "call bit-equal")
            s = summary["fused_modconv3x3"]
            key = "max_abs_err" if fp32 else "bf16_max_abs_err"
            s[key] = max(s[key], err)
        for (hw, c) in dict.fromkeys(k1_step):
            check_k1(summary, B, hw, c, dtype, rand)
    return summary, len(k2_shapes), len(k1_path)


def check_k1(summary, B, hw, c, dtype, rand):
    """Phase 2, K1 and K1 bwd at one DFBlock input [B, hw, hw, c]: held
    against the plain versions, K1 bwd's z against K1's output and a
    second call bit for bit."""
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_affine as fa

    fp32 = dtype == torch.float32
    name = "fp32" if fp32 else "bf16"
    x = rand(B, hw, hw, c, dtype=dtype)
    vecs = [rand(B, c, dtype=dtype) for _ in range(4)]
    dy = rand(B, hw, hw, c, dtype=dtype)
    out = fa.fused_double_affine_leaky(x, *vecs)
    ref = fa.reference_double_affine_leaky(x, *vecs)
    got = fa.fused_double_affine_leaky_bwd(x, *vecs, dy, want_z=True)
    again = fa.fused_double_affine_leaky_bwd(x, *vecs, dy, want_z=True)
    no_z = fa.fused_double_affine_leaky_bwd(x, *vecs, dy)
    ref_b = fa.reference_double_affine_leaky_bwd(x, *vecs, dy)
    torch.cuda.synchronize()
    tag = f"{name} {(B, hw, hw, c)}"
    err = _held(f"K1 {tag}", out, ref, fp32, 1e-6, -7)
    err_dx = _held(f"K1 bwd dx {tag}", got[0], ref_b[0], fp32, 1e-6, -7)
    err_v = max(_held(f"K1 bwd d{v} {tag}", g, r, fp32, 1e-4, -6)
                for v, g, r in zip(("g1", "b1", "g2", "b2"), got[1:5],
                                   ref_b[1:]))
    if not torch.equal(got[5], out):
        raise AssertionError(f"K1 bwd {tag}: z differs from K1's output")
    if not all(torch.equal(a, b) for a, b in zip(got, again)) or not all(
            torch.equal(a, b) for a, b in zip(got, no_z)):
        raise AssertionError(f"K1 bwd {tag}: a second call, or the call "
                             "without z, differs")
    top = ref.float().abs().max().item()
    log(f"[kernels] K1 {name} x[{B},{hw},{hw},{c}]: max_abs_err {err:.3g} "
        f"max_rel_err {err / top:.3g} | K1 bwd max_abs_err dx "
        f"{err_dx:.3g} dg/db {err_v:.3g}, z bit-equal, second call and the "
        "call without z bit-equal")
    if fp32:
        f, b = (summary["fused_double_affine_leaky"],
                summary["fused_double_affine_leaky_bwd"])
        f["max_abs_err"] = max(f["max_abs_err"], err)
        b["max_abs_err"] = max(b["max_abs_err"], err_dx, err_v)


def resblock_shapes(gcfg):
    """(H, Cin, Cout) of every residual block of one generator forward."""
    return [(gcfg.base_size * 2 ** i, cin, cout)
            for i, (cin, cout) in enumerate(gcfg.block_channels)]


def check_resblock(gcfg):
    """Phase 2, K3: `fused_resblock_g` at every residual-block shape of the
    generator, batch 8, fp32 (TF32 off) and bf16, against its plain
    version and a second call bit for bit; its fp32 backward against the
    plain composition's autograd. Returns the summary entry and the number
    of K3 launches the phase made."""
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_resblock as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    B = KERNEL_BATCH
    before = fr.fused_resblock_g.launches
    s = dict(route="cuda", source="gan_codes_tpu_torch/csrc/fused_resblock.cu",
             replaces="gan_codes_tpu/ops/pallas/fused_resblock.py:157",
             max_abs_err=0.0, bf16_max_abs_err=0.0)

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale
                ).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
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
            again = fr.fused_resblock_g(*args)
            ref = fr.reference_resblock_g(*args)
            torch.cuda.synchronize()
            err = _held(f"K3 {name} {(B, hw, hw, cin, cout)}", out, ref,
                        fp32, 2e-4, -5)
            if not torch.equal(out, again):
                raise AssertionError(f"K3 {name} {(B, hw, hw, cin, cout)}: "
                                     "a second call differs")
            top = ref.float().abs().max().item()
            log(f"[kernels] K3 {name} x[{B},{hw},{hw},{cin}] -> {cout}"
                f"{' +1x1' if sc else ''}: max_abs_err {err:.3g} "
                f"max_rel_err {err / top:.3g}, second call bit-equal")
            if not fp32:
                s["bf16_max_abs_err"] = max(s["bf16_max_abs_err"], err)
                continue
            s["max_abs_err"] = max(s["max_abs_err"], err)
            # backward: the Function (recompute with K1 + cuDNN, K1 bwd)
            # against the plain composition's autograd, every input's
            # gradient
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
            log(f"[kernels] K3 backward fp32 x[{B},{hw},{hw},{cin}] -> "
                f"{cout}: worst per-input max|err|/max|ref| {worst:.3g}")
            del ins, leaves, out, ref, got, want
    return s, fr.fused_resblock_g.launches - before


def _gammas_away_from_0(g, seed: int) -> None:
    """Every block gamma of `g` drawn in [0.25, 0.75], away from the 0
    init."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)


def _seeded_generator(seed: int):
    """A seeded random full-width generator, block gammas away from 0."""
    import torch

    from gan_codes_tpu_torch.config import GeneratorConfig
    from gan_codes_tpu_torch.models.generator import Generator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = Generator(GeneratorConfig())
    _gammas_away_from_0(g, seed)
    return g


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
    _gammas_away_from_0(g, SEED)
    torch.save(g.state_dict(), os.path.join(root, "weights", "gen_1.pth"))
    torch.save(te.state_dict(), os.path.join(root, "text_encoder.pth"))
    words = ["<end>", "<unk>", "a", "this", "bird", "has", "red", "blue",
             "yellow", "small", "wings", "belly", "black", "white", "beak"]
    words += [f"w{i}" for i in range(5450 - len(words))]
    code2word = dict(enumerate(words))
    word2code = {w: i for i, w in code2word.items()}
    with open(os.path.join(root, "data", "captions.pickle"), "wb") as f:
        pickle.dump(([], [], code2word, word2code), f)


def write_inception(path: str) -> None:
    """A seeded random InceptionV3 state_dict in torchvision's layout
    (`random_torchvision_state_dict`: BN with random running stats, so the
    fold is exercised)."""
    import torch

    from gan_codes_tpu_torch.models.inception import \
        random_torchvision_state_dict

    torch.save(random_torchvision_state_dict(
        torch.Generator().manual_seed(SEED)), path)


def post(url: str, payload: dict, path: str = "/generate"):
    req = urllib.request.Request(url + path,
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def get(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def serve(root: str, k2_per_forward: int, k1_per_forward: int):
    """Phase 3. Returns (K2 launches, K1 launches)."""
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
    sampler.warmup()
    log(f"[serve] gen_{epoch}.pth: {gcfg.image_size}px n_channels "
        f"{gcfg.n_channels}, {sum(p.numel() for p in sampler.generator.parameters())} "
        "G params")
    server = serve_mod.make_http_server(sampler, port=0, epoch=epoch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bs = sampler.batch_size
    batches = 0
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
        # single-prompt requests, one at a time
        for _ in range(SINGLE_REQUESTS):
            code, body = post(url, {"prompts": ["a bird"]})
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
    if (metrics["generate_ok"] != 2 + SINGLE_REQUESTS
            or metrics["images_total"] != 23 + SINGLE_REQUESTS):
        raise AssertionError(f"/metrics {metrics}")
    log(f"[serve] {batches} batches dispatched over HTTP: K2 launches {k2}, "
        f"K1 launches {k1}; /metrics generate_ok {metrics['generate_ok']}, "
        f"images_total {metrics['images_total']}")
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
    bf16 = serve_mod.build_sampler(*args, batch_size=bs, dtype="bfloat16")[0]
    outb = bf16.pipeline(captions, cap_lens, noise).float()
    log(f"[serve] bf16 batch vs fp32 kernel path: max_abs_err "
        f"{(outb - out).abs().max().item():.3g}")
    bf16.throughput(n_batches=2)  # its card-only branch, CUDA events
    return k2, k1


BURST = 16                       # phase 3b: concurrent one-prompt requests
COALESCE_S = 0.05                # phase 3b: the window, --coalesce-ms 50
WATCH_S = 0.2                    # phase 3b: the poll, --watch 0.2


def _write_gen(weights: str, name: str, seed: int) -> None:
    """A seeded full-width generator's state_dict as `name`, written to a
    temporary name and renamed into place, as the trainer writes."""
    import torch

    tmp = os.path.join(weights, name + ".tmp")
    torch.save(_seeded_generator(seed).state_dict(), tmp)
    os.replace(tmp, os.path.join(weights, name))


def _burst(url: str, n: int):
    """n one-prompt requests sent at once: their codes."""
    codes = [None] * n

    def one(i):
        try:
            codes[i] = post(url, {"prompts": ["a small red bird"]})[0]
        except Exception as e:  # the gate below reports it
            codes[i] = repr(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    return codes


def _running(server) -> str:
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _closed(server) -> None:
    server.shutdown()
    server.server_close()


def serve_rest(root: str, k2_per_forward: int, k1_per_forward: int):
    """Phase 3b. Returns {path: (K2, K1) launches}."""
    import torch

    from gan_codes_tpu_torch import serve as serve_mod
    from gan_codes_tpu_torch.models.torch_import import load_generator
    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    K2 = fused_modconv.fused_modconv3x3
    K1 = fused_affine.fused_double_affine_leaky
    weights = os.path.join(root, "weights")
    args = (os.path.join(root, "data"), os.path.join(root, "text_encoder.pth"),
            weights)
    bs = 16
    sampler, epoch = serve_mod.build_sampler(*args, batch_size=bs)
    if epoch != 1:
        raise AssertionError(f"phase 3's weights dir serves gen_{epoch}")
    for i, name in enumerate(("gen_2.pth", "gen_ema_1.pth",
                              "gen_ema_2.pth")):
        _write_gen(weights, name, SEED + 10 + i)
    tok = np.random.default_rng(SEED + 3)
    captions = tok.integers(1, 5450, (bs, 18))
    cap_lens = tok.integers(1, 19, (bs,))
    noise = torch.randn((bs, 100), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    launches = {}

    def on_file(name: str):
        return serve_mod.Sampler(
            sampler.cfg, load_generator(os.path.join(weights, name))[0],
            sampler.text_encoder, batch_size=bs)

    def same_as(s, name: str, what: str) -> None:
        got = s.pipeline(captions, cap_lens, noise)
        want = on_file(name).pipeline(captions, cap_lens, noise)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{what}: a batch differs from a sampler built on {name} "
                f"(max|err| {(got - want).abs().max().item()})")

    # (a) --ema
    ema, ema_epoch = serve_mod.build_sampler(*args, batch_size=bs,
                                             use_ema=True)
    if ema_epoch != 2:
        raise AssertionError(f"--ema serves gen_ema_{ema_epoch}")
    same_as(ema, "gen_ema_2.pth", "--ema")
    del ema
    log("[serve-rest] (a) build_sampler(use_ema=True) serves "
        "gen_ema_2.pth: a batch equals a sampler on it bit for bit")

    # (b) POST /reload under traffic
    server = serve_mod.make_http_server(sampler, port=0, epoch=epoch,
                                        reloader=sampler.reload_generator)
    url = _running(server)
    traffic, pause = threading.Event(), threading.Lock()
    codes = []

    def client_loop():
        while traffic.is_set():
            with pause:
                try:
                    code = post(url, {"prompts": ["a small red bird"]})[0]
                except Exception as e:  # the gate below reports it
                    code = repr(e)
                codes.append(code)

    traffic.set()
    compared = [0, 0]  # K2, K1 of the comparisons, which are not served
    K2.launches = K1.launches = 0  # main path starts here
    th = threading.Thread(target=client_loop)
    th.start()
    try:
        time.sleep(0.3)
        for payload, want, pinned, name in (({}, 2, False, "gen_2.pth"),
                                            ({"epoch": 1}, 1, True,
                                             "gen_1.pth")):
            code, body = post(url, payload, "/reload")
            if (code, body["epoch"], body["pinned"]) != (200, want, pinned):
                raise AssertionError(f"POST /reload {payload}: {code} {body}")
            time.sleep(0.3)  # traffic on the new weights
            with pause:  # no request in flight
                before = K2.launches, K1.launches
                same_as(sampler, name, f"after POST /reload {payload}")
                compared[0] += K2.launches - before[0]
                compared[1] += K1.launches - before[1]
            h = get(url, "/healthz")
            if (h["epoch"], h["pinned"]) != (want, pinned):
                raise AssertionError(f"/healthz after {payload}: {h}")
        m = get(url, "/metrics")
    finally:
        traffic.clear()
        th.join(60)
        _closed(server)
    k2, k1 = K2.launches - compared[0], K1.launches - compared[1]  # ends
    n = len(codes)
    bad = [c for c in codes if c != 200]
    if m["reloads_total"] != 2 or bad or n < 10 or \
            (k2, k1) != (k2_per_forward * n, k1_per_forward * n):
        raise AssertionError(f"/reload under traffic: reloads_total "
                             f"{m['reloads_total']}, {n} requests, not 200: "
                             f"{bad[:3]}; K2 {k2}, K1 {k1}")
    launches["serve_reload"] = (k2, k1)
    log(f"[serve-rest] (b) POST /reload {{}} -> epoch 2, {{\"epoch\": 1}} -> "
        f"pinned epoch 1, each then equal to a sampler on its file bit for "
        f"bit; {n} one-prompt requests alongside, all 200")

    # (c) --watch
    server = serve_mod.make_http_server(
        sampler, port=0, epoch=1, reloader=sampler.reload_generator,
        watch_interval=WATCH_S, latest_epoch_fn=sampler.latest_generator_epoch)
    url = _running(server)
    try:
        for name, want in (("gen_2.pth", 2), ("gen_3.pth", 3)):
            if want == 3:
                _write_gen(weights, "gen_3.pth", SEED + 13)
            t = time.perf_counter()
            while get(url, "/healthz")["epoch"] != want:
                if time.perf_counter() - t > 10:
                    raise AssertionError(f"--watch: epoch {want} not served "
                                         "within 10 s")
                time.sleep(0.02)
        code, _ = post(url, {"epoch": 3}, "/reload")
        _write_gen(weights, "gen_4.pth", SEED + 14)
        time.sleep(1.0)
        h = get(url, "/healthz")
    finally:
        _closed(server)
    if code != 200 or (h["epoch"], h["pinned"]) != (3, True):
        raise AssertionError(f"--watch: the pin on epoch 3 did not hold "
                             f"against gen_4.pth: {h}")
    log(f"[serve-rest] (c) --watch {WATCH_S}: gen_3.pth (temp + rename) "
        "served within 10 s; the pin on epoch 3 held against gen_4.pth for "
        "1 s")

    # (d) --coalesce-ms: one burst coalesced, the same burst without
    for window in (COALESCE_S, None):
        server = serve_mod.make_http_server(sampler, port=0, epoch=3,
                                            coalesce_window=window)
        url = _running(server)
        try:
            K2.launches = K1.launches = 0  # main path starts here
            codes = _burst(url, BURST)
            k2, k1 = K2.launches, K1.launches  # main path ends here
            m = get(url, "/metrics")
        finally:
            _closed(server)
        n = m.get("coalesced_dispatches", BURST)
        if any(c != 200 for c in codes) or (window and n > 4) or \
                (k2, k1) != (k2_per_forward * n, k1_per_forward * n):
            raise AssertionError(f"burst (coalesce {window}): codes {codes}, "
                                 f"{n} dispatches, K2 {k2}, K1 {k1}")
        key = "coalesced" if window else "plain"
        launches[f"serve_burst_{key}"] = (k2, k1)
        log(f"[serve-rest] (d) {BURST} one-prompt requests at once, {key}: "
            f"all 200, {n} dispatches")

    # (e) data-parallel serving: two replicas on the one card, and the
    # CLI's --dp (every card: one here), against the plain sampler
    plain = serve_mod.build_sampler(*args, batch_size=bs, seed=SEED)[0]
    samplers = {
        "plain": plain,
        "dp1": serve_mod.build_sampler(*args, batch_size=bs, seed=SEED,
                                       data_parallel=True)[0],
        "dp2": serve_mod.Sampler(
            plain.cfg, load_generator(os.path.join(weights, "gen_4.pth"))[0],
            plain.text_encoder, batch_size=bs, seed=SEED,
            devices=["cuda:0", "cuda:0"])}
    caps = np.concatenate([captions, captions[:4]])  # 20 rows: 2 batches
    lens = np.concatenate([cap_lens, cap_lens[:4]])
    want = samplers["plain"].generate_tokens(caps, lens)
    errs = {}
    for key in ("dp1", "dp2"):
        K2.launches = K1.launches = 0  # main path starts here
        got = samplers[key].generate_tokens(caps, lens)
        k2, k1 = K2.launches, K1.launches  # main path ends here
        reps = len(samplers[key].replicas)
        errs[key] = float(np.abs(got - want).max())
        if not np.allclose(got, want, atol=1e-4, rtol=1e-4) or \
                (k2, k1) != (2 * reps * k2_per_forward,
                             2 * reps * k1_per_forward):
            raise AssertionError(f"{key}: max|err| {errs[key]}, K2 {k2}, "
                                 f"K1 {k1} over 2 batches x {reps} replicas")
        launches[f"serve_{key}"] = (k2, k1)
    for key in ("plain", "dp2"):  # throughput's card-only branch, a pair
        # of CUDA events on each replica's card
        samplers[key].throughput(n_batches=2)
    log(f"[serve-rest] (e) 20 rows (2 batches of 16): dp1 (the CLI's --dp "
        f"here: {[str(d) for d, _, _ in samplers['dp1'].replicas]}) and dp2 "
        f"([cuda:0, cuda:0]) against the plain "
        f"sampler max|err| {json.dumps(errs)}")
    del samplers, plain
    out = os.path.join(root, "served_dp")
    paths = serve_mod.main(*args, out, ["a small red bird", "a blue bird"],
                           batch_size=bs, data_parallel=True)
    if len(paths) != 2 or not all(os.path.exists(p) for p in paths):
        raise AssertionError(f"serve.main(data_parallel=True): {paths}")
    return launches


def _train_setup(dtype: str, batch: int = TRAIN_BATCH, remat: bool = False,
                 debug_nans: bool = False):
    """Seeded full-width train state (every block gamma of G and D away
    from 0), the frozen text encoder, the step, and a seeded batch; G
    recomputes its blocks in the backward with `remat`, and the step
    fails fast on a NaN with `debug_nans`."""
    import torch

    from gan_codes_tpu_torch.config import (GANConfig, GeneratorConfig,
                                            TrainConfig)
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.train.state import create_train_state
    from gan_codes_tpu_torch.train.step import make_train_step

    cfg = GANConfig(generator=GeneratorConfig(remat_blocks=remat),
                    train=TrainConfig(batch_size=batch,
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
    b, size = batch, cfg.generator.image_size
    images = torch.rand((b, size, size, 3), generator=dev,
                        device="cuda") * 2 - 1
    captions = torch.randint(1, cfg.text_encoder.vocab_size,
                             (b, cfg.text_encoder.max_len), generator=dev,
                             device="cuda")
    cap_lens = torch.randint(1, cfg.text_encoder.max_len + 1, (b,),
                             generator=gen)
    return cfg, state, te, make_train_step(cfg, debug_nans=debug_nans), (
        images, captions, cap_lens)


def _counters():
    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    return (fused_modconv.fused_modconv3x3,
            fused_affine.fused_double_affine_leaky,
            fused_affine.fused_double_affine_leaky_bwd)


def train():
    """Phase 4. Returns the K2, K1 and K1 bwd launches over the counted
    steps."""
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_modconv
    from gan_codes_tpu_torch.ops.nn import PenaltyConv2d
    from gan_codes_tpu_torch.train import losses

    k2, k1, k1b = _counters()
    counts = None
    for dtype in ("float32", "bfloat16"):
        cfg, state, te, step, batch = _train_setup(dtype)
        log(f"[train] {dtype}: 256px batch {TRAIN_BATCH}, G "
            f"{sum(p.numel() for p in state.generator.parameters())} and D "
            f"{sum(p.numel() for p in state.discriminator.parameters())} "
            "params")
        if dtype == "float32":
            k2.launches = k1.launches = k1b.launches = 0  # main path
            PenaltyConv2d.weight_terms = 0
            metrics = [step(state, te, *batch) for _ in range(TRAIN_STEPS)]
            counts = (k2.launches, k1.launches, k1b.launches)  # ends here
            terms = PenaltyConv2d.weight_terms
            log(f"[train] MA-GP weight terms over {TRAIN_STEPS} steps: "
                f"{terms} (want {19 * TRAIN_STEPS}, 19 a step)")
            if terms != 19 * TRAIN_STEPS:
                raise AssertionError(f"PenaltyConv2d.weight_terms {terms}")
            # per step: K2 at each DFBlock its _supported takes, K1 at the
            # others; K1 bwd at every DFBlock (K2's backward runs it with z
            # for h, and no K1)
            shapes = dfblock_shapes(cfg.generator)
            n_k2 = sum(fused_modconv._supported(
                torch.empty(3, 3, cin, cout, device="meta"))
                for _, cin, cout in shapes)
            want = (n_k2 * TRAIN_STEPS, (len(shapes) - n_k2) * TRAIN_STEPS,
                    len(shapes) * TRAIN_STEPS)
            log(f"[train] launches over {TRAIN_STEPS} steps: K2 {counts[0]}, "
                f"K1 {counts[1]}, K1 bwd {counts[2]} (want {want})")
            if counts != want:
                raise AssertionError(f"launch counters {counts} != {want}")
            # the first step is the eager warm-up, every later one a replay
            log(f"[train] steps replayed as CUDA graphs: {step.replays} of "
                f"{step.steps} (want {TRAIN_STEPS - 1})")
            if step.replays != TRAIN_STEPS - 1:
                raise AssertionError(f"step.replays {step.replays}")
        else:
            metrics = [step(state, te, *batch) for _ in range(TRAIN_STEPS)]
        rows = [{k: v.item() for k, v in m.items()} for m in metrics]
        for i, r in enumerate(rows):
            log(f"[train] {dtype} step {i}: {json.dumps(r)}")
            if not all(np.isfinite(v) for v in r.values()):
                raise AssertionError(f"non-finite metrics at step {i}: {r}")
        del state, step

    # (a) phase 3 alone against one D: G forward + backward (the kernels'
    # backward) from one state, through the kernels and through the plain
    # versions; (b) one whole fp32 step, D learning, from one state each
    # way; (c) phase 3 again, against the D that (b)'s kernels step left
    cfg, state, te, step, (_, captions, cap_lens) = _train_setup(
        "float32")
    noise = torch.randn((TRAIN_BATCH, cfg.generator.latent_dim),
                        generator=torch.Generator(device="cuda"
                                                  ).manual_seed(SEED),
                        device="cuda")

    def phase3_grads(state):
        g_params = list(state.generator.named_parameters())
        with torch.no_grad():
            sents = te(captions, cap_lens).float()
        fake = state.generator(noise, sents)
        loss = losses.g_hinge_loss(state.discriminator, fake, sents)
        return dict(zip((n for n, _ in g_params), torch.autograd.grad(
            loss, [p for _, p in g_params])))

    def phase3_gap(state, what: str) -> None:
        grads = [_plain_or_kernels(plain, lambda: phase3_grads(state))
                 for plain in (False, True)]
        gap = _grad_gap(*grads)
        log(f"[train] phase-3 G gradients against {what}, kernels vs plain "
            f"versions: {_gap_text(gap)}")
        if gap["max_err"] > 1e-3 * gap["max_ref"]:
            raise AssertionError(f"phase-3 G gradients against {what}: "
                                 f"{gap}")

    phase3_gap(state, "one D")
    del state, step

    # (b) The kernels reach the step through G's fakes and G's backward.
    # Held: the losses, the step's G gradients, and its phase-1 D
    # gradients (the input of D's update). D's parameters after the step
    # are not compared: Adam's first update (beta1 0) is lr * g / (|g| +
    # eps), +-lr for any |g| well above eps, and about 9% of D's gradient
    # elements lie under 1e-7, so rounding decides the sign of a few of
    # them (3 here), which also moves d_gp_loss and g_loss: a G whose
    # rounding differs by an ulp can flip hundreds and move d_gp_loss by
    # 0.2%.
    results = []
    for plain in (False, True):
        cfg, state, te, step, batch = _train_setup("float32")
        d_steps = []
        d_step = state.d_opt.step

        def record(grads, d_step=d_step, d_steps=d_steps):
            grads = list(grads)
            d_steps.append([g.detach().clone() for g in grads])
            d_step(grads)

        state.d_opt.step = record
        m = _plain_or_kernels(plain, lambda: step(state, te, *batch,
                                                  noise=noise))
        d_names = [n for n, _ in state.discriminator.named_parameters()]
        results.append(({k: v.item() for k, v in m.items()},
                        {name: p.grad.detach().clone() for name, p in
                         state.generator.named_parameters()},
                        dict(zip(d_names, d_steps[0])),
                        {name: p.detach().clone() for name, p in
                         state.discriminator.named_parameters()}))
        del state, step, d_steps
    (m_k, g_k, d_k, dp_k), (m_p, g_p, d_p, dp_p) = results
    for key in ("d_loss", "d_gp_loss", "g_loss"):
        if not np.isclose(m_k[key], m_p[key], rtol=1e-4, atol=0.0):
            raise AssertionError(f"{key}: kernels {m_k[key]} plain "
                                 f"{m_p[key]}")
    step_gap, d_gap = _grad_gap(g_k, g_p), _grad_gap(d_k, d_p)
    lr = cfg.optim.d_lr
    moved = sum(int(((dp_k[n] - dp_p[n]).abs() > lr / 4).sum())
                for n in dp_p)
    loss_gaps = {k: abs(m_k[k] - m_p[k]) / abs(m_p[k])
                 for k in ("d_loss", "d_gp_loss", "g_loss")}
    log(f"[train] one fp32 step, kernels vs plain versions: losses "
        f"{json.dumps(m_k)} vs {json.dumps(m_p)} (relative gaps "
        f"{json.dumps(loss_gaps)}; D parameters over lr/4 apart after "
        f"the step: {moved}); phase-1 D gradients: {_gap_text(d_gap)}; "
        f"phase-3 G gradients: {_gap_text(step_gap)}")
    if d_gap["max_err"] > 1e-3 * d_gap["max_ref"]:
        raise AssertionError(f"phase-1 D gradients of one step: {d_gap}")
    if step_gap["max_err"] > 1e-3 * step_gap["max_ref"]:
        raise AssertionError(f"phase-3 G gradients of one step: {step_gap}")

    _, state, te, step, _ = _train_setup("float32")
    with torch.no_grad():
        for name, p in state.discriminator.named_parameters():
            p.copy_(dp_k[name])
    phase3_gap(state, "the D one kernels step left")
    del state, step
    _repeatability()
    return counts


def _repeatability() -> None:
    """REPEAT_STEPS fp32 steps, twice from one seeded state, on cuDNN's
    default and on its deterministic algorithms: the G and D parameters
    that differ between the two runs. Holds none for the deterministic
    ones (train_entry's `deterministic`, which phases 5 and 7a run)."""
    import torch

    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        try:
            runs = []
            for _ in range(2):
                _, state, te, step, batch = _train_setup("float32")
                for _ in range(REPEAT_STEPS):
                    step(state, te, *batch)
                runs.append([p.detach().clone() for m in (
                    state.generator, state.discriminator)
                    for p in m.parameters()])
                del state, step
        finally:
            torch.backends.cudnn.deterministic = False
        out["deterministic" if det else "default"] = [
            sum(not torch.equal(a, b) for a, b in zip(*runs)), len(runs[0])]
    log(f"[train] {REPEAT_STEPS} fp32 steps twice from one state, parameters "
        f"that differ [n, of]: cuDNN default {out['default']}, "
        f"deterministic {out['deterministic']}")
    if out["deterministic"][0]:
        raise AssertionError(f"deterministic cuDNN: {out['deterministic']} "
                             "parameters differ run to run")


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


def train_entry_phase(root: str, inception_path: str):
    """Phase 5. Returns (K2, K1, K1 bwd launches over the three
    `train_entry.train` calls, run A's histories)."""
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

    data = os.path.join(root, "cub")
    info = make_synthetic_cub(data, n_train=ENTRY_TRAIN, n_test=ENTRY_TEST,
                              image_size=256, seed=SEED)
    cfg = GANConfig.for_image_size(256, vocab_size=info["n_words"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        te = RNNEncoder(cfg.text_encoder)
    te_path = os.path.join(root, "entry_text_encoder.pth")
    torch.save(te.state_dict(), te_path)

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
                  inception_weights_path=inception_path, device="cuda",
                  deterministic=True)
        tee = _Tee(sys.stdout)
        k2.launches = k1.launches = k1b.launches = 0  # main path starts
        with mock.patch.object(train_entry, "Trainer", Recorded), \
                contextlib.redirect_stdout(tee):
            hist = train_entry.train(data, te_path,
                                     os.path.join(root, f"{name}_images"),
                                     os.path.join(root, f"{name}_weights"),
                                     **kw)
        counts = (k2.launches, k1.launches, k1b.launches)  # ends here
        return hist, counts, tee.buf.getvalue(), Recorded.made[-1]

    hist_a, counts_a, _, tr_a = run("a", 2)
    hist_b1, counts_b1, _, tr_b1 = run("b", 1)
    saved_b = _snapshot(state_to_dict(tr_b1.state))
    hist_b2, counts_b2, out_b2, tr_b2 = run("b", 2)

    # counters: per step one K2 per DFBlock K2 takes and one K1 per other
    # DFBlock, one K1 bwd per DFBlock (14, 0, 14 at 256px); per eval batch
    # (one test batch each epoch) a generator forward (14 K2, 0 K1)
    shapes = dfblock_shapes(tr_a.cfg.generator)
    n_k2 = sum(fused_modconv._supported(
        torch.empty(3, 3, cin, cout, device="meta")) for _, cin, cout in shapes)
    n_df = len(shapes)
    totals = [0, 0, 0]
    for counts, epochs in ((counts_a, 2), (counts_b1, 1), (counts_b2, 1)):
        steps = epochs * steps_per_epoch
        want = (n_k2 * (steps + epochs), (n_df - n_k2) * (steps + epochs),
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
    for key in ("g_losses", "d_losses", "d_gp_losses", "txtimg_losses",
                "is_scores", "fid_scores"):
        a, b = hist_a[key][1], hist_b2[key][1]
        if b != a:
            raise AssertionError(f"epoch 2 {key}: run A {a}, resumed run B "
                                 f"{b} (deterministic cuDNN: bit for bit)")
        if not np.isfinite(a):
            raise AssertionError(f"epoch 2 {key} not finite: {a}")
    log(f"[entry] epoch 2, resumed B equals uninterrupted A bit for bit: "
        f"{json.dumps({k: v[1] for k, v in hist_a.items()})}")
    scores = {}
    for name in ("a", "b"):
        wdir = os.path.join(root, f"{name}_weights")
        for f in ("histories.json", "metrics_log.jsonl", "config.json",
                  "checkpoint", "gen_1.pth", "gen_ema_1.pth"):
            if not os.path.exists(os.path.join(wdir, f)):
                raise AssertionError(f"run {name}: {f} missing")
        with open(os.path.join(wdir, "metrics_log.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["epoch"] for r in rows] != [0, 1]:
            raise AssertionError(f"run {name}: metrics rows {rows}")
        for r in rows:  # json writes inf as the string "Infinity"
            is_s, fid = r["is_score"], r["fid_score"]
            if not (isinstance(fid, float) and np.isfinite(fid)
                    and np.isfinite(is_s) and is_s > 1.0):
                raise AssertionError(f"run {name} epoch {r['epoch']}: IS "
                                     f"{is_s}, FID {fid}")
        scores[name] = [(r["is_score"], r["fid_score"]) for r in rows]
        grid = os.path.join(root, f"{name}_images", "fake_sample_epoch_1.png")
        if not os.path.exists(grid):
            raise AssertionError(f"run {name}: sample grid missing")
    log(f"[entry] IS, FID per epoch (24 test images a side, random "
        f"Inception weights): run A {scores['a']}, run B {scores['b']}")
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
    return tuple(totals), hist_a


class _EvalLoader(list):
    """A deterministic test loader (unshuffled, un-augmented), so the
    trainer caches its real side."""
    shuffle = False
    dataset = type("Dataset", (), {"augment": False})


def _score_gaps(got, want) -> list:
    """[|IS gap| / (IS - 1), |FID gap| / FID] of (IS, FID) pairs: IS is
    held as IS - 1, which is about 1e-4 with random Inception weights."""
    return [abs(got[0] - want[0]) / (want[0] - 1.0),
            abs(got[1] - want[1]) / want[1]]


def _scores_close(got, want) -> bool:
    is_gap, fid_gap = _score_gaps(got, want)
    return is_gap <= EVAL_IS_RTOL and fid_gap <= EVAL_FID_RTOL


def eval_phase(root: str, inception_path: str):
    """Phase 6. Returns the K2 and K1 launches of two `Trainer.evaluate`
    calls."""
    from unittest import mock

    import torch

    from gan_codes_tpu_torch.config import GANConfig
    from gan_codes_tpu_torch.eval import metrics
    from gan_codes_tpu_torch.models.inception import (inception_to,
                                                      load_torch_inception)
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.ops.kernels import fused_modconv
    from gan_codes_tpu_torch.train.trainer import Trainer

    cfg = GANConfig.for_image_size(256, batch_size=TRAIN_BATCH,
                                   eval_max_batches=EVAL_BATCHES)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        te = RNNEncoder(cfg.text_encoder)
    trainer = Trainer(cfg, te, os.path.join(root, "weights"),
                      os.path.join(root, "images"),
                      inception_params=load_torch_inception(inception_path),
                      seed=SEED, device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in trainer.state.generator.named_parameters():
            if name.endswith(".gamma"):  # away from the 0 init
                p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
    rng = np.random.default_rng(SEED)
    size, length = cfg.generator.image_size, cfg.text_encoder.max_len
    loader = _EvalLoader(
        {"images": rng.integers(0, 256, (TRAIN_BATCH, size, size, 3),
                                dtype=np.uint8),
         "captions": rng.integers(1, cfg.text_encoder.vocab_size,
                                  (TRAIN_BATCH, length), dtype=np.int64),
         "cap_lens": rng.integers(1, length + 1, TRAIN_BATCH)}
        for _ in range(EVAL_BATCHES))
    n = EVAL_BATCHES * TRAIN_BATCH
    params = trainer.inception_params
    log(f"[eval] {EVAL_BATCHES} batches x {TRAIN_BATCH} = {n} images a side, "
        f"256px G (n_channels 32) fakes, seeded 256px reals, random "
        f"Inception weights from {os.path.basename(inception_path)}")

    # the main path: two epochs' evaluations, the first computing the real
    # side, the second reading it from the cache
    k2, k1, k1b = _counters()
    k2.launches = k1.launches = k1b.launches = 0  # the eval path starts
    scores = []
    for _ in range(2):
        trainer._eval_rng = trainer._epoch_generator(0)
        scores.append(trainer.evaluate(loader)[:2])
    counts = (k2.launches, k1.launches, k1b.launches)  # ends here
    shapes = dfblock_shapes(cfg.generator)
    n_k2 = sum(fused_modconv._supported(
        torch.empty(3, 3, cin, cout, device="meta"))
        for _, cin, cout in shapes)
    want = (2 * EVAL_BATCHES * n_k2, 2 * EVAL_BATCHES * (len(shapes) - n_k2),
            0)
    log(f"[eval] launches over 2 evaluations (K2, K1, K1 bwd): {counts} "
        f"(want {want}); IS, FID: first {scores[0]}, cached real side "
        f"{scores[1]}")
    if counts != want:
        raise AssertionError(f"eval launch counters {counts} != {want}")
    for is_s, fid in scores:
        if not (np.isfinite(is_s) and is_s > 1.0 and np.isfinite(fid)):
            raise AssertionError(f"eval scores IS {is_s}, FID {fid}")
    if not _scores_close(scores[1], scores[0]):
        raise AssertionError(f"cached real side changed the scores: "
                             f"{scores}")

    # the same evaluation in its parts
    trainer._eval_rng = trainer._epoch_generator(0)
    fakes = torch.cat([trainer.generate(b["captions"], b["cap_lens"])
                       for b in loader])
    reals = torch.cat([trainer._device_batch(b)[0] for b in loader])

    def inception(fn, images):
        return metrics._batched(fn, params, images, 8)

    table = {("_logits_batch", id(fakes)): inception(metrics._logits_batch,
                                                     fakes),
             ("_features_batch", id(fakes)): inception(
                 metrics._features_batch, fakes),
             ("_features_batch", id(reals)): inception(
                 metrics._features_batch, reals)}
    with mock.patch.object(metrics, "_batched", lambda fn, p, im, bs:
                           table[(fn.__name__, id(im))]):
        parts = metrics.compute_is_fid(params, fakes, reals)
    log(f"[eval] IS, FID from the evaluation's parts {parts}")
    if not _scores_close(parts, scores[0]):
        raise AssertionError(f"parts {parts} against evaluate {scores[0]}")

    # the card against the CPU: the network on 8 images, then IS/FID over
    # EVAL_SUBSET images a side through the low-rank cross term
    cpu = inception_to(params, "cpu")
    x = torch.cat([reals[:4], fakes[:4]])
    with torch.inference_mode():
        f_card = metrics._features_batch(params, x).cpu().numpy()
        f_cpu = metrics._features_batch(cpu, x.cpu()).numpy()
        p_card = metrics._logits_batch(params, x).cpu().numpy()
        p_cpu = metrics._logits_batch(cpu, x.cpu()).numpy()
    gaps = {"features": float(np.abs(f_card - f_cpu).max()),
            "features_max": float(np.abs(f_cpu).max()),
            "softmax": float(np.abs(p_card - p_cpu).max())}
    if not (np.allclose(f_card, f_cpu, atol=2e-4, rtol=1e-3)
            and np.allclose(p_card, p_cpu, atol=1e-4, rtol=0.0)):
        raise AssertionError(f"inception card vs CPU: {gaps}")
    sub_f, sub_r = fakes[:EVAL_SUBSET], reals[:EVAL_SUBSET]
    with mock.patch.object(metrics, "sqrtm_trace_lowrank",
                           wraps=metrics.sqrtm_trace_lowrank) as lowrank:
        on_card = metrics.compute_is_fid(params, sub_f, sub_r)
        on_cpu = metrics.compute_is_fid(cpu, sub_f.cpu(), sub_r.cpu())
    gaps["is_minus_1_fid_rel"] = _score_gaps(on_card, on_cpu)
    log(f"[eval] card vs CPU: 8 images {json.dumps(gaps)}; IS, FID over "
        f"{EVAL_SUBSET} a side: card {on_card}, CPU {on_cpu}, low-rank calls "
        f"{lowrank.call_count}")
    if lowrank.call_count != 2:
        raise AssertionError("the low-rank cross term was not taken")
    if not (np.all(np.isfinite(on_card))
            and _scores_close(on_card, on_cpu)):
        raise AssertionError(f"IS/FID card {on_card} vs CPU {on_cpu}")
    trainer.close()
    return counts[:2]


DP_LOCAL_BATCH = 12              # phase 7b: two ranks on one card, 12 + 12
DP_EVAL_PER_RANK = 24            # phase 7b: fakes a rank for IS/FID
DP_TIMEOUT_S = 420               # each phase-7 child process


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_entry_child(spec: dict) -> int:
    """Phase 7a's child: one rank of `train_entry.train(data_parallel=
    True)`; prints one "DP_ENTRY {json}" line with the histories and the
    launch and collective counters."""
    sys.path.insert(0, REPO)
    from gan_codes_tpu_torch import train_entry
    from gan_codes_tpu_torch.parallel import mesh as pmesh

    k2, k1, k1b = _counters()
    k2.launches = k1.launches = k1b.launches = 0  # main path starts
    pmesh.all_reduce.calls = pmesh.broadcast.calls = 0
    hist = train_entry.train(
        spec["data"], spec["te"], spec["images"], spec["weights"],
        image_size=256, batch_size=TRAIN_BATCH, num_epochs=2, seed=SEED,
        n_channels=32, compute_dtype="float32",
        inception_weights_path=spec["inception"], device="cuda",
        data_parallel=True, deterministic=True)
    counts = [k2.launches, k1.launches, k1b.launches]  # main path ends
    print("DP_ENTRY " + json.dumps({
        "hist": hist, "counts": counts,
        "all_reduce_calls": pmesh.all_reduce.calls,
        "broadcast_calls": pmesh.broadcast.calls}), flush=True)
    return 0


def dp_phase(root: str, inception_path: str, hist_a: dict):
    """Phase 7. Returns the K2, K1 and K1 bwd launches of 7a's main
    path."""
    import torch

    from gan_codes_tpu_torch.config import GeneratorConfig
    from gan_codes_tpu_torch.ops.kernels import fused_modconv

    torch.cuda.empty_cache()  # the children share the card
    # (a) train_entry --dp at world size 1 over NCCL, in a child process
    spec = {"data": os.path.join(root, "cub"),
            "te": os.path.join(root, "entry_text_encoder.pth"),
            "inception": inception_path,
            "images": os.path.join(root, "dp_images"),
            "weights": os.path.join(root, "dp_weights")}
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", GROUP_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--dp-entry-child", json.dumps(spec)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=DP_TIMEOUT_S)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("DP_ENTRY ")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"train_entry --dp child failed (rc "
                             f"{r.returncode}):\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    child = json.loads(lines[-1][len("DP_ENTRY "):])
    hist = child["hist"]
    gaps = {}
    for key in ("g_losses", "d_losses", "d_gp_losses", "txtimg_losses"):
        gaps[key] = [abs(b - a) / max(abs(a), 1e-30)
                     for a, b in zip(hist_a[key], hist[key])]
        if len(hist[key]) != 2 or not np.allclose(hist[key], hist_a[key],
                                                  rtol=1e-3, atol=0.0):
            raise AssertionError(f"--dp {key} {hist[key]} against run A "
                                 f"{hist_a[key]}")
    score_gaps = [_score_gaps((i, f), (ia, fa)) for i, f, ia, fa in zip(
        hist["is_scores"], hist["fid_scores"], hist_a["is_scores"],
        hist_a["fid_scores"])]
    if any(g[0] > ENTRY_IS_RTOL or g[1] > ENTRY_FID_RTOL
           for g in score_gaps):
        raise AssertionError(f"--dp IS/FID {hist['is_scores']} "
                             f"{hist['fid_scores']} against run A "
                             f"{hist_a['is_scores']} {hist_a['fid_scores']}")
    shapes = dfblock_shapes(GeneratorConfig())
    n_k2 = sum(fused_modconv._supported(
        torch.empty(3, 3, cin, cout, device="meta")) for _, cin, cout in shapes)
    steps, evals = 2 * (ENTRY_TRAIN // TRAIN_BATCH), 2
    want = [n_k2 * (steps + evals), (len(shapes) - n_k2) * (steps + evals),
            len(shapes) * steps]
    if child["counts"] != want:
        raise AssertionError(f"--dp launch counters {child['counts']} != "
                             f"{want}")
    if child["all_reduce_calls"] != 4 * steps + 1:
        raise AssertionError(f"--dp all-reduces {child['all_reduce_calls']}"
                             f" != {4 * steps + 1}")
    log(f"[dp] (a) train_entry --dp, world 1 over NCCL, 256px batch 24 "
        f"fp32, 2 epochs: losses and IS/FID against run A {json.dumps(gaps)}"
        f" {score_gaps}; launches (K2, K1, K1 bwd) {child['counts']}; "
        f"{child['all_reduce_calls']} all-reduces and "
        f"{child['broadcast_calls']} broadcasts")

    # (b) two ranks on the one card over gloo: the step and the eval
    r = subprocess.run(
        [sys.executable, "-m", "gan_codes_tpu_torch.tools.dp_check",
         "--device", "cuda:0", "--image-size", "256",
         "--n-channels", "32", "--local-batch", str(DP_LOCAL_BATCH),
         "--steps", "1", "--inception", inception_path, "--eval-per-rank",
         str(DP_EVAL_PER_RANK), "--timeout", str(DP_TIMEOUT_S - 60),
         "--seed", str(SEED)],
        cwd=REPO, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"dp_check failed (rc {r.returncode}):\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    report = json.loads(lines[-1])
    log(f"[dp] (b) 2 ranks on one card over gloo, 256px 12 + 12 against "
        f"one process at 24: {json.dumps(report['steps'])}; IS/FID "
        f"{json.dumps(report.get('eval'))}")
    return tuple(want)


INTEROP_LEFT_OUT = ("discriminator", "img_forward.1.gamma")  # no Adam entry
INTEROP_TIMEOUT_S = 300          # phase 8: each torch_import process


def _torch_import(*argv: str) -> str:
    r = subprocess.run([sys.executable, "-m",
                        "gan_codes_tpu_torch.models.torch_import", *argv],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=INTEROP_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"torch_import {argv} failed (rc "
                             f"{r.returncode}):\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    return r.stdout


def interop_phase(root: str):
    """Phase 8. Returns the K2, K1 and K1 bwd launches of the resumed
    `train_entry`."""
    import contextlib

    import torch
    from PIL import Image

    from gan_codes_tpu_torch import serve as serve_mod
    from gan_codes_tpu_torch import train_entry
    from gan_codes_tpu_torch.config import GANConfig
    from gan_codes_tpu_torch.generate import load_vocab
    from gan_codes_tpu_torch.models.torch_import import (load_text_encoder,
                                                         reference_order)
    from gan_codes_tpu_torch.train.state import create_train_state
    from gan_codes_tpu_torch.train.step import make_train_step

    data = os.path.join(root, "cub")
    te_path = os.path.join(root, "entry_text_encoder.pth")
    n_words = len(load_vocab(data)[0])
    # a full-width fp32 state after 2 steps, as the reference would save it
    cfg = GANConfig.for_image_size(256, vocab_size=n_words,
                                   batch_size=TRAIN_BATCH)
    state = create_train_state(cfg, SEED, device="cuda")
    for module in (state.generator, state.discriminator):
        _gammas_away_from_0(module, SEED)
    te = load_text_encoder(te_path)[0].cuda().eval().requires_grad_(False)
    dev = torch.Generator(device="cuda").manual_seed(SEED)
    images = torch.rand((TRAIN_BATCH, 256, 256, 3), generator=dev,
                        device="cuda") * 2 - 1
    captions = torch.randint(1, n_words, (TRAIN_BATCH, 18), generator=dev,
                             device="cuda")
    cap_lens = torch.randint(1, 19, (TRAIN_BATCH,),
                             generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(cfg)
    for _ in range(2):
        step(state, te, images, captions, cap_lens)
    ck = {"epoch": 0, "g_losses": [0.5], "d_losses": [1.5],
          "d_gp_losses": [0.1], "txtimg_losses": [0.9], "is_scores": [1.0],
          "fid_scores": [300.0]}
    source = {}
    for key, opt_key, module, opt in (
            ("generator", "g_optimizer", state.generator, state.g_opt),
            ("discriminator", "d_optimizer", state.discriminator,
             state.d_opt)):
        ref = reference_order({k: v.detach().cpu()
                               for k, v in module.state_dict().items()})
        adam = opt.adam.state_dict()
        names = [n for n, _ in module.named_parameters()]
        by_name = {n: {f: v.detach().cpu() for f, v in
                       adam["state"][i].items()} for i, n in enumerate(names)}
        source[key] = (ref, by_name)
        ck[key] = ref
        ck[opt_key] = {
            "state": {j: by_name[k] for j, k in enumerate(ref)
                      if (key, k) != INTEROP_LEFT_OUT},
            "param_groups": [dict(adam["param_groups"][0],
                                  params=list(range(len(ref))))]}
    pt = os.path.join(root, "reference_checkpoint.pt")
    torch.save(ck, pt)

    # the import, a process of its own as a user runs it
    out = os.path.join(root, "imported_weights")
    said = _torch_import("--ckpt", pt, "--out", out, "--vocab-size",
                         str(n_words), "--batch-size", str(TRAIN_BATCH))
    if "1 param(s) had no Adam state" not in said:
        raise AssertionError(f"the import did not name the parameter "
                             f"without Adam state:\n{said}")
    blob = torch.load(os.path.join(out, "checkpoint"), map_location="cpu",
                      weights_only=True)
    n_tensors = 0
    for key, opt in (("generator", "g_opt"), ("discriminator", "d_opt")):
        ref, by_name = source[key]
        module = state.generator if key == "generator" else \
            state.discriminator
        n_tensors += _bit_equal(_snapshot(blob[key]), ref, key)
        if key == "generator":
            n_tensors += _bit_equal(_snapshot(blob["g_ema"]), ref, "g_ema")
        for i, (n, _) in enumerate(module.named_parameters()):
            got, want = blob[opt]["state"][i], by_name[n]
            if (key, n) == INTEROP_LEFT_OUT:
                want = {"step": want["step"],
                        "exp_avg": torch.zeros_like(want["exp_avg"]),
                        "exp_avg_sq": torch.zeros_like(want["exp_avg_sq"])}
            n_tensors += _bit_equal(_snapshot(got), want, f"{opt}.{n}")
    if blob["step"] != 2:
        raise AssertionError(f"imported step {blob['step']} != 2")
    log(f"[interop] reference checkpoint.pt (256px fp32 state after 2 "
        f"steps, reference key order, no Adam entry for "
        f"{INTEROP_LEFT_OUT}) imported by `python -m gan_codes_tpu_torch."
        f"models.torch_import --ckpt`: {n_tensors} tensors bit for bit (G, "
        f"D, EMA, exp_avg, exp_avg_sq, steps), step 2")

    # train_entry resumes it: one more epoch of 2 steps on phase 5's data
    k2, k1, k1b = _counters()
    tee = _Tee(sys.stdout)
    k2.launches = k1.launches = k1b.launches = 0  # main path starts here
    with contextlib.redirect_stdout(tee):
        hist = train_entry.train(data, te_path,
                                 os.path.join(root, "imported_images"), out,
                                 image_size=256, batch_size=TRAIN_BATCH,
                                 num_epochs=2, n_channels=32, device="cuda")
    counts = (k2.launches, k1.launches, k1b.launches)  # main path ends here
    steps = ENTRY_TRAIN // TRAIN_BATCH
    want = (14 * (steps + 1), 0, 14 * steps)
    if "Resuming from epoch 1" not in tee.buf.getvalue():
        raise AssertionError("train_entry did not resume the import")
    if counts != want or len(hist["g_losses"]) != 2 or not all(
            np.isfinite(hist[k][1]) for k in ("g_losses", "d_losses",
                                              "d_gp_losses")):
        raise AssertionError(f"resumed epoch: launches {counts} (want "
                             f"{want}), histories {hist}")
    log(f"[interop] train_entry --weights <import> resumed from epoch 1: "
        f"{steps} steps and one eval batch, launches (K2, K1, K1 bwd) "
        f"{counts}, losses {json.dumps({k: v[1] for k, v in hist.items()})}")

    # --export, then serve one request from the exported file
    served = os.path.join(root, "exported")
    os.makedirs(served)
    exported = os.path.join(served, "gen_1.pth")
    _torch_import("--export", out, "--out", exported)
    _bit_equal(_snapshot(torch.load(exported, weights_only=True)),
               _snapshot(torch.load(os.path.join(out, "gen_1.pth"),
                                    weights_only=True)), "export")
    sampler, epoch = serve_mod.build_sampler(data, te_path, served,
                                             batch_size=4)
    server = serve_mod.make_http_server(sampler, port=0, epoch=epoch)
    url = _running(server)
    try:
        code, body = post(url, {"prompts": ["this bird has a red crown"]})
    finally:
        _closed(server)
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        body["images"][0]))))
    if code != 200 or img.shape != (256, 256, 3):
        raise AssertionError(f"serving the export: {code} {img.shape}")
    log("[interop] --export of gen_1.pth equals the weights dir's bit for "
        "bit and serves one 256px PNG")
    return counts


LONGRUN_EPOCHS, LONGRUN_KILL = 2, 1  # phase 9e: epochs, SIGKILL after
LEG_TIMEOUT_S = 300              # phase 9e: each longrun leg's limit


def up_blocks(gcfg):
    """(index, h, Cin, Cout) of every block the JAX package's default path
    runs as `res_block_g_up` (all but the first), h its low-res input."""
    return [(i, gcfg.base_size * 2 ** (i - 1), cin, cout)
            for i, (cin, cout) in enumerate(gcfg.block_channels) if i]


def up_block_phase():
    """Phase 9 (a) and (b). Returns the K2, K1 and K1 bwd launches of the
    counted `res_block_g_up` calls."""
    import copy

    import torch

    from gan_codes_tpu_torch.config import GeneratorConfig
    from gan_codes_tpu_torch.ops import blocks
    from gan_codes_tpu_torch.ops import nn as ops_nn
    from gan_codes_tpu_torch.ops.kernels.fused_modconv import _supported

    gcfg = GeneratorConfig()
    g = _seeded_generator(SEED + 9).cuda()
    stack = list(g.res_blocks) + [g.res_block_out]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    B = KERNEL_BATCH
    k2, k1, k1b = _counters()
    counted = [0, 0, 0]

    def counted_call(fn, want, what):
        k2.launches = k1.launches = k1b.launches = 0  # main path starts
        out = fn()
        got = (k2.launches, k1.launches, k1b.launches)  # main path ends
        if got != want:
            raise AssertionError(f"{what}: launches (K2, K1, K1 bwd) {got}, "
                                 f"want {want}")
        for j in range(3):
            counted[j] += got[j]
        return out

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    # (a) res_block_g_up against res_block_g(upsample(x)) (cuDNN's conv_1
    # against K2's), against its plain versions, its fp32 backward against
    # the plain composition's autograd
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
        sent = rand(B, gcfg.sentence_dim, dtype=dtype)
        for i, h, cin, cout in up_blocks(gcfg):
            block = copy.deepcopy(stack[i]).to(dtype)
            x = rand(B, h, h, cin, dtype=dtype)
            what = f"up-block {i} {name} x[{B},{h},{h},{cin}] -> {cout}"
            # K1 runs DFBlock-1's chain at low res; DFBlock-2 is K2 where
            # _supported takes conv_2, else K1 and a torch conv
            k2_blk = int(_supported(block.conv_2.weight.permute(2, 3, 1, 0)))
            fwd = (k2_blk, 2 - k2_blk, 0)

            def up(xx=x, ss=sent, blk=block):
                return blocks.res_block_g_up(blk, xx, ss)

            def kernel_path(xx=x, ss=sent, blk=block):
                return blocks.res_block_g(blk, ops_nn.upsample_nearest_2x(xx),
                                          ss)

            with torch.no_grad():
                out = counted_call(up, fwd, what)
                ref = kernel_path()
                plain = _plain_or_kernels(True, up)
            torch.cuda.synchronize()
            err = _held(f"{what} vs res_block_g(upsample(x))", out, ref,
                        fp32, 2e-4, -5)
            err_plain = _held(f"{what} vs its plain versions", out, plain,
                              fp32, 2e-4, -5)
            if fp32:
                xg = x.detach().requires_grad_()
                sg = sent.detach().requires_grad_()
                leaves = [xg, sg] + list(block.parameters())
                dy = rand(B, 2 * h, 2 * h, cout)
                out = counted_call(lambda: up(xg, sg), fwd, what)
                got = counted_call(
                    lambda: torch.autograd.grad(out, leaves, dy), (0, 0, 2),
                    f"{what} backward")
                ref = _plain_or_kernels(True, lambda: kernel_path(xg, sg))
                want = torch.autograd.grad(ref, leaves, dy)
                worst = 0.0
                for j, (a, b) in enumerate(zip(got, want)):
                    e = (a - b).abs().max().item()
                    t = b.abs().max().item()
                    worst = max(worst, e / max(t, 1e-30))
                    if e > 1e-3 * t:
                        raise AssertionError(f"{what} backward input {j}: "
                                             f"max|err| {e} max|ref| {t}")
                del xg, sg, leaves, dy, out, got, ref, want
            log(f"[rest] {what}: max_abs_err {err:.3g} vs the kernel path, "
                f"{err_plain:.3g} vs plain" + (
                    f" | backward worst max|err|/max|ref| {worst:.3g}"
                    if fp32 else ""))

    # (b) the sub-pixel conv at the six conv_1 shapes, fp32
    for i, h, cin, cout in up_blocks(gcfg):
        conv = stack[i].conv_1
        x = rand(B, h, h, cin)
        with torch.no_grad():
            got = ops_nn.conv3x3_on_upsampled(x, conv.weight, conv.bias)
            want = ops_nn.conv2d(ops_nn.upsample_nearest_2x(x), conv.weight,
                                 conv.bias, padding=1)
            if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
                raise AssertionError(
                    f"conv3x3_on_upsampled x[{B},{h},{h},{cin}] -> {cout}: "
                    f"max|err| {(got - want).abs().max().item()}")
        log(f"[rest] conv3x3_on_upsampled fp32 x[{B},{h},{h},{cin}] -> "
            f"{cout}: max_abs_err {(got - want).abs().max().item():.3g}")
    log(f"[rest] six up-blocks, batch {B}: counted launches (K2, K1, K1 "
        f"bwd) {tuple(counted)}")
    return tuple(counted)


def examples_tools_phase(root: str, k2_per_forward: int,
                         k1_per_forward: int):
    """Phase 9 (c), (d) and (e). Returns {path: (K2, K1, K1 bwd)
    launches}."""
    from unittest import mock

    import torch
    from PIL import Image

    from gan_codes_tpu_torch.examples import eval_example, train_example
    from gan_codes_tpu_torch.tools import longrun, validate_pretrained

    k2, k1, k1b = _counters()
    launches = {}
    per_fwd = (k2_per_forward, k1_per_forward, 0)

    def times(n, counts=per_fwd):
        return tuple(n * c for c in counts)

    # (c) the train example at full width, then the eval example on it
    work = os.path.join(root, "example")
    k2.launches = k1.launches = k1b.launches = 0  # main path starts here
    train_example.main(work=work, device="cuda", image_size=256,
                       batch_size=TRAIN_BATCH, n_train=ENTRY_TRAIN,
                       n_test=ENTRY_TEST)
    counts = (k2.launches, k1.launches, k1b.launches)  # main path ends here
    steps = 2 * (ENTRY_TRAIN // TRAIN_BATCH)
    evals = 2 * (ENTRY_TEST // TRAIN_BATCH)
    want = times(steps + evals)[:2] + (
        (k2_per_forward + k1_per_forward) * steps,)
    if counts != want:
        raise AssertionError(f"train example: launches (K2, K1, K1 bwd) "
                             f"{counts}, want {want}")
    launches["train_example"] = counts
    data, weights = (os.path.join(work, "data"),
                     os.path.join(work, "gen_weights"))
    out = os.path.join(root, "eval_out")
    k2.launches = k1.launches = k1b.launches = 0  # main path starts here
    eval_example.main(["--data", data, "--weights", weights,
                       "--image-size", "256", "--out", out])
    counts = (k2.launches, k1.launches, k1b.launches)  # main path ends here
    if counts != times(2):  # the test batch and the caption's
        raise AssertionError(f"eval example: launches (K2, K1, K1 bwd) "
                             f"{counts}, want {times(2)}")
    launches["eval_example"] = counts
    pngs = [os.path.join(out, "batch", f)
            for f in sorted(os.listdir(os.path.join(out, "batch")))]
    pngs += [os.path.join(out, "own_bird.png")] + [
        os.path.join(work, "gen_images", f"fake_sample_epoch_{e}.png")
        for e in (0, 1)]
    shapes = [np.asarray(Image.open(p)).shape for p in pngs]
    n_batch = min(8, ENTRY_TEST)  # the eval example's test batch
    if len(pngs) != n_batch + 3 or any(sh[2] != 3 for sh in shapes) or any(
            sh[:2] != (256, 256) for sh in shapes[:n_batch + 1]):
        raise AssertionError(f"the examples' PNGs: {list(zip(pngs, shapes))}")
    log(f"[rest] train example (256px, batch {TRAIN_BATCH}, "
        f"{ENTRY_TRAIN} + {ENTRY_TEST} images, 2 epochs), launches "
        f"{launches['train_example']}; eval example, launches "
        f"{launches['eval_example']}; {len(pngs)} PNGs")

    # (d) the validate tool: --self-test (its assets under root), then
    # --check-weights on the example's weights dir
    with mock.patch.object(tempfile, "tempdir", root):
        rc = validate_pretrained.main(["--self-test"])
    if rc != 0:
        raise AssertionError(f"validate_pretrained --self-test: exit {rc}")
    k2.launches = k1.launches = k1b.launches = 0  # main path starts here
    rc = validate_pretrained.main(["--check-weights", weights])
    counts = (k2.launches, k1.launches, k1b.launches)  # main path ends here
    if rc != 0 or counts != times(1):
        raise AssertionError(f"validate_pretrained --check-weights: exit "
                             f"{rc}, launches {counts} (want {times(1)})")
    launches["validate_check_weights"] = counts

    # (e) the long run: SIGKILL after epoch 1, resumed, against its twin
    # (child processes: their launches are not counted here)
    torch.cuda.empty_cache()  # the children share the card
    lr_out = os.path.join(root, "longrun")
    rc = longrun.main(["--device", "cuda", "--image-size", "256",
                       "--batch-size", str(TRAIN_BATCH),
                       "--epochs", str(LONGRUN_EPOCHS),
                       "--kill-after-epoch", str(LONGRUN_KILL),
                       "--data", data, "--out", lr_out,
                       "--leg-timeout", str(LEG_TIMEOUT_S)])
    with open(os.path.join(lr_out, "LONGRUN.json")) as f:
        report = json.load(f)
    if rc != 0 or not report["equivalent"]:
        raise AssertionError(f"longrun: exit {rc}, report {report}")
    said = {k: report[k] for k in ("resume_print", "loss_health")}
    log(f"[rest] validate_pretrained --self-test and --check-weights: exit "
        f"0; longrun (256px, batch {TRAIN_BATCH}, {LONGRUN_EPOCHS} epochs, "
        f"SIGKILL after epoch {LONGRUN_KILL}) equivalent bit for bit "
        f"{json.dumps(said)}")
    return launches


# phase 10: this slice's options at full width
REMAT_ARMS = (("float32", TRAIN_BATCH), ("bfloat16", TRAIN_BATCH),
              ("bfloat16", 128))   # 128: the largest bf16 batch of BENCH_r05
# The step at "high" (one TF32 pass) against "highest" (fp32), from one
# state: TF32 keeps 10 of fp32's 23 mantissa bits, so rounding both
# operands moves a product by up to 2 x 2^-11 of its magnitude; a logit or
# a gradient of the step passes about 40 convolutions (G's 29 and D's 10
# on the longest path, forward or backward), each adding at most that
# share of the magnitudes it sums: TF32_STEP_TOL = 40 x 2 x 2^-11 (3.9%).
# Held: max|err| over all G and phase-1 D gradients within that share of
# max|ref|; the hinge losses d_loss and g_loss, means of logits against
# the margin 1 (g_loss a mean of logits near 0, whose own relative gap
# cancellation inflates), within TF32_STEP_TOL x max(1, |ref|); d_gp_loss,
# coef x mean(|grad|^6), 6 times the relative error of a norm that passes
# D's 10 convolutions and their 10 input gradients, within rtol
# TF32_GP_TOL = 6 x 20 x 2 x 2^-11 (11.7%).
# phase 10 (a): one TF32 pass drifts from float64 at least this many
# times as far as 3xTF32 at every shape (on an H100 80GB HBM3 at 700 W
# the ratio is 260x to 950x)
MODE_DRIFT_RATIO = 10
TF32_STEP_TOL = 40 * 2 * 2.0 ** -11
TF32_GP_TOL = 6 * 20 * 2 * 2.0 ** -11


def _precision(p):
    """Set the process's fp32 precision; returns the one it replaces."""
    from gan_codes_tpu_torch.utils.device import set_matmul_precision

    return set_matmul_precision(p)


def check_one_pass(gcfg):
    """Phase 10 (a): K2 at every DFBlock and K3 at every block of the
    generator, batch 8, fp32, in one TF32 pass (precision "high") and in
    3xTF32 ("highest") on the same inputs. Each one-pass call against its
    plain version of that mode (both conv operands rounded to TF32, the
    products exact: the 3xTF32 tolerances, K2 allclose 1e-4, K3 2e-4) and
    a second call bit for bit; both modes' drift from the float64 plain
    version (TF32's error at its size beside 3xTF32's; one pass at least
    MODE_DRIFT_RATIO times 3xTF32's, so each mode ran). Returns {kernel
    name: extra keys for its entry}."""
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_modconv
    from gan_codes_tpu_torch.ops.kernels import fused_resblock as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    B = KERNEL_BATCH

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def modes(call, want_one, ref64, name):
        """(one-pass out, its plain version, drift one, drift three)."""
        previous = _precision("highest")
        try:
            three = call()
            _precision("high")
            one, again = call(), call()
            want = want_one()
        finally:
            _precision(previous)
        torch.cuda.synchronize()
        if not torch.equal(one, again):
            raise AssertionError(f"{name} one pass: a second call differs")
        top64 = ref64.abs().max().item()
        d1 = (one.double() - ref64).abs().max().item() / top64
        d3 = (three.double() - ref64).abs().max().item() / top64
        # each mode ran the products it was asked for: one TF32 pass
        # drifts from float64 by TF32's rounding (2^-11 an operand),
        # 3xTF32 by fp32's, hundreds of times less; a kernel that ignored
        # its mode argument gives d1 == d3
        if not d1 > MODE_DRIFT_RATIO * d3:
            raise AssertionError(f"{name}: drift from float64 one pass {d1}"
                                 f", 3xTF32 {d3}: not {MODE_DRIFT_RATIO}x "
                                 "apart, so a mode was not run")
        return one, want, d1, d3

    out = {}
    for kernel in ("fused_modconv3x3", "fused_resblock_g"):
        out[kernel] = dict(one_pass_max_abs_err=0.0,
                           one_pass_drift_vs_float64=0.0,
                           one_pass_3xtf32_drift_vs_float64=0.0)
    for hw, cin, cout in dfblock_shapes(gcfg):
        x = rand(B, hw, hw, cin)
        g1, b1, g2, b2 = (rand(B, cin) for _ in range(4))
        w = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        bias = rand(cout, scale=0.1)
        args = (x, g1, b1, g2, b2, w, bias)
        ref64 = fused_modconv.reference_modconv3x3(*(a.double() for a in args))
        name = f"K2 x[{B},{hw},{hw},{cin}] -> {cout}"
        one, want, d1, d3 = modes(
            lambda: fused_modconv.fused_modconv3x3(*args),
            lambda: fused_modconv.reference_modconv3x3(*args, tf32=True),
            ref64, name)
        err = _held(f"{name} one pass", one, want, True, 1e-4, 0)
        del ref64
        _one_pass_row(out["fused_modconv3x3"], name, err, d1, d3)

    for hw, cin, cout in resblock_shapes(gcfg):
        sc = cin != cout
        args = ([rand(B, hw, hw, cin)] + [rand(B, cin, scale=0.5)
                                          for _ in range(4)]
                + [rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                   rand(cout, scale=0.1)]
                + [rand(B, cout, scale=0.5) for _ in range(4)]
                + [rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                   rand(cout, scale=0.1), torch.full((1,), 0.7, device=dev)]
                + ([rand(1, 1, cin, cout, scale=cin ** -0.5),
                    rand(cout, scale=0.1)] if sc else [None, None]))
        ref64 = fr.reference_resblock_g(*(None if a is None else a.double()
                                          for a in args))
        name = f"K3 x[{B},{hw},{hw},{cin}] -> {cout}{' +1x1' if sc else ''}"
        with torch.no_grad():
            one, want, d1, d3 = modes(
                lambda: fr.fused_resblock_g(*args),
                lambda: fr.reference_resblock_g(*args, tf32=True),
                ref64, name)
        err = _held(f"{name} one pass", one, want, True, 2e-4, 0)
        del ref64
        _one_pass_row(out["fused_resblock_g"], name, err, d1, d3)
    return out


def _one_pass_row(s: dict, name: str, err: float, d1: float,
                  d3: float) -> None:
    """Logs one shape of phase 10 (a) and folds it into the kernel's
    entry."""
    log(f"[one-pass] {name}: one pass max_abs_err {err:.3g} against its "
        f"plain version (tf32 operands), second call bit-equal | drift from "
        f"float64: one pass {d1:.3g}, 3xTF32 {d3:.3g}")
    for key, v in (("one_pass_max_abs_err", err),
                   ("one_pass_drift_vs_float64", d1),
                   ("one_pass_3xtf32_drift_vs_float64", d3)):
        s[key] = max(s[key], v)


def _one_step(setup, noise):
    """One step from a fresh `setup()` state with `noise`: its metrics, G's
    gradients and the phase-1 D gradients, and its K2, K1 and K1 bwd
    launches (the counters set to 0 just before the step, read just
    after)."""
    cfg, state, te, step, batch = setup()
    k2, k1, k1b = _counters()
    d_grads = []
    d_step = state.d_opt.step

    def record(grads):
        grads = list(grads)
        d_grads.append([g.detach().clone() for g in grads])
        d_step(grads)

    state.d_opt.step = record
    k2.launches = k1.launches = k1b.launches = 0  # main path
    m = step(state, te, *batch, noise=noise)
    launches = (k2.launches, k1.launches, k1b.launches)  # ends here
    state.d_opt.step = d_step
    # on the host, so that they weigh on no later step of the card
    d_names = [n for n, _ in state.discriminator.named_parameters()]
    grads = {"G." + n: p.grad.detach().cpu()
             for n, p in state.generator.named_parameters()}
    grads.update(("D." + n, g.cpu()) for n, g in zip(d_names, d_grads[0]))
    return {k: v.item() for k, v in m.items()}, grads, launches


def options_steps():
    """Phase 10 (b), (c), (e): one fp32 step at precision "highest" and at
    "high"; the step with and without `remat_blocks` in fp32 and bf16
    (batch 24, bf16 also 128); a NaN in G or D under `debug_nans`.
    Returns the K2, K1 and K1 bwd launches of the counted steps."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    noise24 = torch.randn((TRAIN_BATCH, 100), generator=gen, device="cuda")

    # (b) precision: one step's losses and gradients at "high" against
    # "highest" from one state
    previous = _precision(None)
    try:
        runs = {}
        for p in ("highest", "high"):
            _precision(p)
            runs[p] = _one_step(lambda: _train_setup("float32"), noise24)[:2]
    finally:
        _precision(previous)
    (m_hi, g_hi), (m_tf, g_tf) = runs["highest"], runs["high"]
    loss_gaps = {k: abs(m_tf[k] - m_hi[k]) / abs(m_hi[k])
                 for k in ("d_loss", "d_gp_loss", "g_loss")}
    loss_held = {k: abs(m_tf[k] - m_hi[k]) / max(1.0, abs(m_hi[k]))
                 for k in ("d_loss", "g_loss")}
    loss_held["d_gp_loss"] = loss_gaps["d_gp_loss"] / TF32_GP_TOL \
        * TF32_STEP_TOL
    gap = _grad_gap(g_tf, g_hi)
    log(f"[options] one fp32 step at high against highest: losses "
        f"{json.dumps(m_tf)} vs {json.dumps(m_hi)} (relative gaps "
        f"{json.dumps(loss_gaps)}; held: d_loss, g_loss gap / max(1, "
        f"|ref|) <= {TF32_STEP_TOL:.3g}, d_gp_loss rtol {TF32_GP_TOL:.3g})"
        f"; G and phase-1 D gradients: {_gap_text(gap)} (held <= "
        f"{TF32_STEP_TOL:.3g})")
    if any(v > TF32_STEP_TOL for v in loss_held.values()):
        raise AssertionError(f"losses at high vs highest: {loss_gaps}")
    if gap["max_err"] > TF32_STEP_TOL * gap["max_ref"]:
        raise AssertionError(f"gradients at high vs highest: {gap}")

    # (c) remat: from one seeded state with and without, on deterministic
    # cuDNN (the same algorithms each way): the step's gradients, bit for
    # bit, its launches
    launches = [0, 0, 0]
    for dtype, b in REMAT_ARMS:
        noise = torch.randn((b, 100), generator=gen, device="cuda")
        arms = {}
        for remat in (False, True):
            torch.backends.cudnn.deterministic = True
            try:
                m, grads, counts = _one_step(
                    lambda: _train_setup(dtype, b, remat), noise)
            finally:
                torch.backends.cudnn.deterministic = False
            want = (28, 0, 14) if remat else (14, 0, 14)
            if counts != want:
                raise AssertionError(f"{dtype} batch {b} remat {remat}: "
                                     f"K2, K1, K1 bwd launches {counts} != "
                                     f"{want}")
            launches = [a + c for a, c in zip(launches, counts)]
            arms[remat] = dict(metrics=m, grads=grads, launches=counts)
        gap = _grad_gap(arms[True]["grads"], arms[False]["grads"])
        same = all(torch.equal(arms[True]["grads"][n], g)
                   for n, g in arms[False]["grads"].items())
        key = f"{dtype}_{b}"
        log(f"[options] {dtype} batch {b}, remat against plain: gradients "
            f"{'bit-equal' if same else _gap_text(gap)}; launches K2, K1, "
            f"K1 bwd {arms[True]['launches']} vs {arms[False]['launches']}")
        if not same:
            # one state, the same noise, deterministic cuDNN, and K2 adds
            # in a fixed order: the recompute gives the first pass's bits
            raise AssertionError(f"remat gradients {key} differ from the "
                                 f"step's without remat: {gap}")
        del arms

    # (e) a NaN in a G weight, then in a D weight, under debug_nans
    raised = {}
    for where, phase in (("G", "G forward"), ("D", "phase 1 (D hinge)")):
        _, state, te, step, batch = _train_setup("float32", debug_nans=True)
        w = state.generator.res_blocks[0].conv_1.weight if where == "G" \
            else state.discriminator.img_forward[0].weight
        with torch.no_grad():
            w[0, 0, 0, 0] = float("nan")
        try:
            step(state, te, *batch)
        except FloatingPointError as e:
            raised[where] = str(e)
            if phase not in str(e):
                raise AssertionError(f"NaN in {where}: raised {e!r}, which "
                                     f"does not name {phase!r}") from e
        else:
            raise AssertionError(f"NaN in a {where} weight under "
                                 "debug_nans: the step did not raise")
        del state, step
    log(f"[options] debug_nans: {json.dumps(raised)}")
    return tuple(launches)


def options_entry_phase(root: str):
    """Phase 10 (d): `train_entry.train` at 256px, batch 24, on a
    synthetic CUB fixture, with precision "high", `remat_g`,
    `device_prefetch` and `deterministic`: run A 2 epochs, run B 1 epoch
    and resumed to 2 (equal to A bit for bit), run C as B's first epoch
    with the uploads on the step's stream, no side stream (equal to it
    bit for bit); the profiler over A's first epoch shows the batches'
    host-to-device copies on a stream of their own. Returns the K2, K1 and
    K1 bwd launches of the runs."""
    import contextlib
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gan_codes_tpu_torch import train_entry
    from gan_codes_tpu_torch.config import GANConfig
    from gan_codes_tpu_torch.data.synthetic import make_synthetic_cub
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.train.checkpoint import state_to_dict
    from gan_codes_tpu_torch.train.trainer import Trainer

    data = os.path.join(root, "cub")
    info = make_synthetic_cub(data, n_train=ENTRY_TRAIN, n_test=ENTRY_TEST,
                              image_size=256, seed=SEED + 12)
    cfg = GANConfig.for_image_size(256, vocab_size=info["n_words"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 12)
        te = RNNEncoder(cfg.text_encoder)
    te_path = os.path.join(root, "text_encoder.pth")
    torch.save(te.state_dict(), te_path)
    streams = {}

    class Recorded(Trainer):
        """The Trainer, keeping each instance, a snapshot of its state as
        the first epoch starts (after any restore), and, where asked, the
        device streams of its first epoch; with `one_stream` its uploads
        run on the step's stream."""
        made = []
        profile_first = False
        one_stream = False

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.at_start = None
            if Recorded.one_stream:
                self._copy_stream = None
            Recorded.made.append(self)

        def train_epoch(self, loader):
            if self.at_start is None:
                self.at_start = _snapshot(state_to_dict(self.state))
                if Recorded.profile_first:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        # the tracer running before the first upload: the
                        # start of a window has lost its first events
                        torch.cuda.synchronize()
                        time.sleep(0.5)
                        mark = torch.empty(1, device=self.device)
                        for _ in range(64):
                            mark.fill_(0.0)
                        torch.cuda.synchronize()
                        out = super().train_epoch(loader)
                        torch.cuda.synchronize()
                    for e in prof.events():
                        if e.device_type == torch.autograd.DeviceType.CUDA:
                            streams.setdefault(e.device_resource_id,
                                               []).append(e.name)
                    return out
            return super().train_epoch(loader)

    k2, k1, k1b = _counters()
    steps_per_epoch = ENTRY_TRAIN // TRAIN_BATCH

    def run(name: str, epochs: int, ran: int = 0):
        """train_entry.train to `epochs`, `ran` of them in this call (all
        unless given)."""
        tee = _Tee(sys.stdout)
        k2.launches = k1.launches = k1b.launches = 0  # main path starts
        with mock.patch.object(train_entry, "Trainer", Recorded), \
                contextlib.redirect_stdout(tee):
            hist = train_entry.train(
                data, te_path, os.path.join(root, f"{name}_images"),
                os.path.join(root, f"{name}_weights"), image_size=256,
                batch_size=TRAIN_BATCH, num_epochs=epochs, seed=SEED,
                device="cuda", deterministic=True, matmul_precision="high",
                remat_g=True, device_prefetch=True)
        counts = (k2.launches, k1.launches, k1b.launches)  # ends here
        trainer = Recorded.made[-1]
        ran = ran or epochs
        steps = ran * steps_per_epoch
        # remat: two K2 a K2 DFBlock a step (14 -> 28), K1 bwd 14; an eval
        # batch a forward (14 K2)
        want = (28 * steps + 14 * ran, 0, 14 * steps)
        if counts != want:
            raise AssertionError(f"run {name}: K2, K1, K1 bwd launches "
                                 f"{counts} != {want}")
        return hist, counts, tee.buf.getvalue(), trainer

    Recorded.profile_first = True
    hist_a, counts_a, _, tr_a = run("a", 2)
    Recorded.profile_first = False
    hist_b1, counts_b1, _, tr_b1 = run("b", 1)
    saved_b = _snapshot(state_to_dict(tr_b1.state))
    hist_b2, counts_b2, out_b2, tr_b2 = run("b", 2, ran=1)
    Recorded.one_stream = True
    hist_c, counts_c, _, tr_c = run("c", 1)
    Recorded.one_stream = False
    saved_c = _snapshot(state_to_dict(tr_c.state))

    if "Resuming from epoch 1" not in out_b2:
        raise AssertionError("run B's second call did not resume")
    n_tensors = _bit_equal(tr_b2.at_start, saved_b)
    for key in ("g_losses", "d_losses", "d_gp_losses", "txtimg_losses"):
        if hist_b2[key][1] != hist_a[key][1]:
            raise AssertionError(f"epoch 2 {key}: run A {hist_a[key][1]}, "
                                 f"resumed run B {hist_b2[key][1]}")
        if not np.isfinite(hist_a[key][1]):
            raise AssertionError(f"epoch 2 {key}: {hist_a[key][1]}")
        if hist_c[key][0] != hist_b1[key][0]:
            raise AssertionError(f"epoch 1 {key}: uploads on a side stream "
                                 f"{hist_b1[key][0]}, on the step's "
                                 f"{hist_c[key][0]}")
    n_c = _bit_equal(saved_c, saved_b)
    if not all(t._copy_stream is not None for t in (tr_a, tr_b1, tr_b2)) \
            or tr_c._copy_stream is not None:
        raise AssertionError("the uploads did not run on a side stream in "
                             "runs A and B, or did in run C")
    log(f"[options-entry] resumed B equals A at epoch 2 bit for bit "
        f"(restored {n_tensors} tensors); C (uploads on the step's stream) "
        f"equals B's first epoch bit for bit ({n_c} tensors); losses "
        f"{json.dumps({k: v[1] for k, v in hist_a.items()})}")

    # the batches' copies, two a batch (images, captions), on a stream that
    # runs no kernel of the step; the step's own stream carries at most
    # the step's one copy (the packed LSTM's batch sizes). On an H100 the
    # profiler has recorded 4, 2 and 0 of the 4 copies of this window's
    # two uploads, missing the step's own copies too, so one batch's two
    # suffice.
    step_streams = {s for s, names in streams.items()
                    if any("fused_modconv3x3_kernel" in n for n in names)}
    copies = {s: sum(n.startswith("Memcpy HtoD") for n in names)
              for s, names in streams.items()}
    side = sum(c for s, c in copies.items() if s not in step_streams)
    on_step = sum(c for s, c in copies.items() if s in step_streams)
    log(f"[options-entry] profiler over run A's first epoch: streams "
        f"{sorted(streams)}, K2's {sorted(step_streams)}, host-to-device "
        f"copies by stream {copies}")
    for s, names in sorted(streams.items()):
        counts = {}
        for n in names:
            counts[n[:60]] = counts.get(n[:60], 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:6]
        log(f"[options-entry] stream {s}: {len(names)} events, {top}")
    if not streams:
        raise AssertionError("the profiler recorded no device event")
    if not step_streams or side < 2 or on_step > steps_per_epoch:
        raise AssertionError(f"{side} host-to-device copies off the step's "
                             f"stream(s) {step_streams} (want at least 2), "
                             f"{on_step} on them (want at most "
                             f"{steps_per_epoch})")
    return tuple(sum(c) for c in zip(counts_a, counts_b1, counts_b2,
                                     counts_c))


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
    _build.build()
    log(f"[build] sm_90a, {len(_build.SOURCES)} sources, one nvcc each in "
        f"parallel, then a link -> {_build.library_path().name}")
    log(f"[device] {nvidia_smi_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    summary, k2_n, k1_n = check_kernels(GeneratorConfig())
    summary["fused_resblock_g"], k3_checks = check_resblock(GeneratorConfig())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="smoke_") as root:
        os.makedirs(os.path.join(root, "weights"))
        os.makedirs(os.path.join(root, "data"))
        write_weights(root)
        k2, k1 = serve(root, k2_n, k1_n)
        rest_launches = serve_rest(root, k2_n, k1_n)
    t_k2, t_k1, t_k1b = train()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="entry_") as root:
        inception_path = os.path.join(root, "inception_v3.pth")
        write_inception(inception_path)
        (e_k2, e_k1, e_k1b), hist_a = train_entry_phase(root, inception_path)
        v_k2, v_k1 = eval_phase(os.path.join(root, "eval"), inception_path)
        d_k2, d_k1, d_k1b = dp_phase(root, inception_path, hist_a)
        i_k2, i_k1, i_k1b = interop_phase(root)
    up_counts = up_block_phase()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="rest_") as root:
        p9_counts = examples_tools_phase(root, k2_n, k1_n)
    one_pass = check_one_pass(GeneratorConfig())
    o_counts = options_steps()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="options_") as root:
        oe_counts = options_entry_phase(root)
    # launches on the main paths; K3 is on none (as in the JAX package),
    # so its only launches are the kernel checks', which do not count
    launches = {"fused_modconv3x3": {"serve": k2, "train": t_k2,
                                     "train_entry": e_k2, "eval": v_k2,
                                     "dp_entry": d_k2,
                                     "interop_resume": i_k2},
                "fused_double_affine_leaky": {"serve": k1, "train": t_k1,
                                              "train_entry": e_k1,
                                              "eval": v_k1, "dp_entry": d_k1,
                                              "interop_resume": i_k1},
                "fused_double_affine_leaky_bwd": {"serve": 0,
                                                  "train": t_k1b,
                                                  "train_entry": e_k1b,
                                                  "eval": 0,
                                                  "dp_entry": d_k1b,
                                                  "interop_resume": i_k1b},
                "fused_resblock_g": {"serve": 0, "train": 0,
                                     "train_entry": 0, "eval": 0,
                                     "dp_entry": 0, "interop_resume": 0}}
    for path, (r_k2, r_k1) in rest_launches.items():
        launches["fused_modconv3x3"][path] = r_k2
        launches["fused_double_affine_leaky"][path] = r_k1
        launches["fused_double_affine_leaky_bwd"][path] = 0
        launches["fused_resblock_g"][path] = 0
    p9_counts["up_block"] = up_counts
    p9_counts["options_steps"] = o_counts
    p9_counts["options_entry"] = oe_counts
    for path, (r_k2, r_k1, r_k1b) in p9_counts.items():
        launches["fused_modconv3x3"][path] = r_k2
        launches["fused_double_affine_leaky"][path] = r_k1
        launches["fused_double_affine_leaky_bwd"][path] = r_k1b
        launches["fused_resblock_g"][path] = 0
    kernels = []
    for name, s in summary.items():
        by_path = dict(launches[name])
        n = sum(by_path.values())
        if name == "fused_resblock_g":
            by_path["kernel_checks"] = k3_checks
        # s: route, source, replaces and the phase-2 errors
        kernels.append({"name": name, **s, "launches": n,
                        "launches_by_path": by_path, "dtype": "float32",
                        "batch": KERNEL_BATCH, **one_pass.get(name, {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-entry-child"]:
        sys.exit(dp_entry_child(json.loads(sys.argv[2])))
    sys.exit(main())

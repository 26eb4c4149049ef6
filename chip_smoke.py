#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gan_codes_tpu_torch`) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failed check raises, so the run exits non-zero):

1. Build: compiles every kernel source in `gan_codes_tpu_torch/csrc/` with
   one nvcc call for sm_90a into one library, prints the build seconds and
   the card's name and power limit.
2. Kernels: calls each kernel's wrapper on the card at the shapes the served
   256px generator gives it (batch 8; K2 at every DFBlock its `_supported`
   takes, K1 at the ones it declines plus [8,128,128,64]), in float32 with
   TF32 off and in bfloat16, and holds each result against the kernel's
   plain PyTorch version on the same inputs. Prints errors, kernel / plain /
   library times (CUDA events) and the bound.
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
4. Prints one {"kernels": [...]} line, the nvidia-smi line, and, last,
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
#   The served image (phase 3, fp32) passes 14 DFBlocks, each reordered:
#   allclose(1e-3, 1e-3).
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


def check_kernels(gcfg):
    """Phase 2. Returns per-kernel summaries for the kernels line."""
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
    k1_shapes = [(128, 64)] + [s for s in k1_path if s != (128, 64)]
    summary = {
        "fused_modconv3x3": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_modconv.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_modconv.py:118",
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
            max_abs_err=0.0, bound_by="operations",
            path_shapes=len(k2_shapes)),
        "fused_double_affine_leaky": dict(
            route="cuda", source="gan_codes_tpu_torch/csrc/fused_affine.cu",
            replaces="gan_codes_tpu/ops/pallas/fused_affine.py:71",
            ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
            max_abs_err=0.0, bound_by="bytes", path_shapes=len(k1_path)),
    }
    log(f"[kernels] per forward: K2 takes {len(k2_shapes)} DFBlocks "
        f"{k2_shapes}, K1 takes {len(k1_path)} {k1_path}")

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale
                ).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        esize = 4 if dtype == torch.float32 else 2
        peak = H100_FP32_FLOPS if dtype == torch.float32 \
            else H100_BF16_TENSOR_FLOPS
        for (hw, cin, cout) in k2_shapes:
            x = rand(B, hw, hw, cin, dtype=dtype)
            g1, b1, g2, b2 = (rand(B, cin, dtype=dtype) for _ in range(4))
            w = rand(3, 3, cin, cout, dtype=dtype, scale=(9 * cin) ** -0.5)
            bias = rand(cout, dtype=dtype, scale=0.1)
            args = (x, g1, b1, g2, b2, w, bias)
            out = fused_modconv.fused_modconv3x3(*args)
            ref = fused_modconv.reference_modconv3x3(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            if dtype == torch.float32:
                ok = torch.allclose(out, ref, atol=1e-4, rtol=1e-4)
            else:
                ok = err <= 2.0 ** -6 * top
            if not ok:
                raise AssertionError(
                    f"K2 {name} {(B, hw, hw, cin, cout)}: max|err| {err} "
                    f"(max|ref| {top}) outside tolerance")
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
            if dtype == torch.float32:
                s = summary["fused_modconv3x3"]
                s["ms"] += ms
                s["plain_ms"] += plain
                s["library_ms"] += lib
                s["bound_ms"] += b_ms
                s["max_abs_err"] = max(s["max_abs_err"], err)
        for (hw, c) in k1_shapes:
            x = rand(B, hw, hw, c, dtype=dtype)
            vecs = [rand(B, c, dtype=dtype) for _ in range(4)]
            out = fused_affine.fused_double_affine_leaky(x, *vecs)
            ref = fused_affine.reference_double_affine_leaky(x, *vecs)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            if dtype == torch.float32:
                ok = torch.allclose(out, ref, atol=1e-6, rtol=1e-6)
            else:
                ok = err <= 2.0 ** -7 * top
            if not ok:
                raise AssertionError(
                    f"K1 {name} {(B, hw, hw, c)}: max|err| {err} "
                    f"(max|ref| {top}) outside tolerance")
            ms = cuda_ms(lambda: fused_affine.fused_double_affine_leaky(
                x, *vecs), 50)
            plain = cuda_ms(lambda: fused_affine.reference_double_affine_leaky(
                x, *vecs), 50)
            n_bytes = (2 * x.numel() + 4 * B * c) * esize
            flops = 6.0 * x.numel()  # 2 x (mul, add, leaky mul)
            b_ms, b_by = bound(n_bytes, flops, H100_FP32_FLOPS)
            log(f"[kernels] K1 {name} x[{B},{hw},{hw},{c}]: max_abs_err "
                f"{err:.3g} max_rel_err {err / top:.3g} | kernel_ms "
                f"{ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.4f} "
                f"({b_by}) | {n_bytes / ms / 1e6:.0f} GB/s"
                + ("" if (hw, c) in k1_path else " (not on the port's path)"))
            if dtype == torch.float32 and (hw, c) in k1_path:
                s = summary["fused_double_affine_leaky"]
                s["ms"] += ms
                s["plain_ms"] += plain
                s["bound_ms"] += b_ms
                s["max_abs_err"] = max(s["max_abs_err"], err)
    return summary, len(k2_shapes), len(k1_path)


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
    if "lstm" in low or "rnn" in low:
        return "LSTM (text encoder)"
    if "fprop" in low or "conv" in low:
        return "torch conv (cuDNN)"
    if "gemm" in low or "cutlass" in low:
        return "GEMM (affine MLPs, linear_in)"
    if "copy" in low or "memset" in low or "memcpy" in low:
        return "copies"
    return "other elementwise"


def profile_breakdown(sampler, captions, cap_lens, noise, n: int = 3):
    """Device time per kernel group over `n` served batches, and the
    device's idle share of the span from the first kernel to the last
    (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sampler.pipeline(captions, cap_lens, noise)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sampler.pipeline(captions, cap_lens, noise)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        log("[profile] the profiler recorded no device events: device time "
            "by kernel not measured")
        return None
    groups, names = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + us
        names[e.name] = names.get(e.name, 0.0) + us
    busy = sum(groups.values())
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    out = {"batch": sampler.batch_size, "dtype": str(sampler.dtype),
           "kernels_per_batch": len(spans) / n,
           "device_busy_ms_per_batch": busy / n / 1e3,
           "span_ms_per_batch": span / n / 1e3,
           "idle_share": 1.0 - busy / span,
           "ms_per_batch": {k: v / n / 1e3 for k, v in
                            sorted(groups.items(), key=lambda kv: -kv[1])}}
    log("[profile] " + json.dumps(out))
    for name, us in sorted(names.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile] {us / n / 1e3:8.3f} ms/batch  {name[:110]}")
    return out


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

    summary, k2_n, k1_n = check_kernels(GeneratorConfig())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR,
                                     prefix="smoke_") as root:
        os.makedirs(os.path.join(root, "weights"))
        os.makedirs(os.path.join(root, "data"))
        write_weights(root)
        k2, k1, numbers = serve(root, k2_n, k1_n)
    log("[serve] " + json.dumps(numbers))
    summary["fused_modconv3x3"]["launches"] = k2
    summary["fused_double_affine_leaky"]["launches"] = k1
    kernels = []
    for name, s in summary.items():
        kernels.append({"name": name, "route": s["route"],
                        "source": s["source"], "replaces": s["replaces"],
                        "launches": s["launches"],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"],
                        "dtype": "float32", "batch": KERNEL_BATCH,
                        "shapes_per_forward": s["path_shapes"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The generator kernels of several trees, each timed alone on one card:
K2 (`fused_modconv3x3`, forward and backward), K1
(`fused_double_affine_leaky` and its backward) as a train step runs them,
and K3 (`fused_resblock_g`, forward), each beside its plain version; K2 and
K3 also in one TF32 pass.

    python3 gan_codes_tpu_torch/tools/kernel_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository (for example
the parent commit unpacked with `git archive` into a directory that
.gitignore lists). Every root's kernels are built first, all at once, each
into its own `gan_codes_tpu_torch/_build/`; then each root, in the order
given, runs in a process of its own. Giving a root twice, in the order
parent, change, change, parent, shows the spread between runs of one tree.

Every call is held against the root's plain version on the same inputs
before it is timed. Eager calls are timed with CUDA events (the mean of
`iters` calls after 3 warm ones); a bound is the larger of the call's
bytes over 3.35 TB/s and its products over the tensor cores (fp32 as
3xTF32: three TF32 products a product over 495 TFLOP/s; one TF32 pass: one;
bf16: over 989 TFLOP/s), from NVIDIA's H100 SXM data sheet.

K2: at every DFBlock of the 256px generator (n_channels 32) that its
`_supported` takes, batch 8, float32 (TF32 off) and bfloat16, held within
fp32 allclose 1e-4 or bf16 max|err| <= 2^-6 max|ref|; 20 calls (50 below
64x64), beside its plain version, cuDNN's `F.conv2d` of the modulated
input in the same dtype and its bound. Its backward (the autograd
Function: cuDNN's input gradient, K1 bwd with h, cuDNN's weight gradient)
beside the plain composition's autograd backward, each input's gradient
within 1e-3 (fp32) or 2^-6 (bf16) of its max|ref|, both timed as device
time (`autograd.grad` captured as K1 is, below). In float32 also its
drift from the float64 plain version beside cuDNN's fp32 conv's
(max|err| / max|ref|), and one TF32 pass (the process's precision "high"):
held against the plain version of that mode (both conv operands rounded to
TF32; allclose 1e-4), beside `F.conv2d` with TF32 on and its bound.

K1: what one train step's backward runs of it at the 14 DFBlock inputs of
that generator (10 distinct shapes), at batch 8 and 24, float32 and
bfloat16. Where the root's `fused_double_affine_leaky_bwd` takes `want_z`,
K2's backward runs one K1 backward that also writes h: that call is timed.
Otherwise (the trees before it) K2's backward runs K1's forward, then K1's
backward: both are timed and added. K1's forward is timed apart too (a
train step runs it where K2 declines a DFBlock). Each call is held against
the root's plain versions (forward and dx fp32 allclose 1e-6, bf16 within
2^-7 max|ref|; the four sums fp32 allclose 1e-4, bf16 within 2^-6
max|ref|; z equal to the forward bit for bit) and timed as device time:
GRAPH_CALLS calls captured in one CUDA graph, its replay timed with CUDA
events; the plain versions as eager calls. The sum over the 14 DFBlocks is
the per-step time. At 4x4 to 32x32 the same calls also run eagerly back to
back: `call_ms`, and `host_ms` = call_ms - device ms, the wrappers' host
cost.

K3: its `fused_resblock_g` at the 7 residual blocks of that generator,
batch 8, float32 (TF32 off) and bfloat16, held within fp32 allclose 2e-4 or
bf16 max|err| <= 2^-5 max|ref|; 5 calls (10 below 64x64), beside its plain
version, the composition (`_composition`: the port's way to compute the
block from K2, cuDNN's 1x1 and torch ops) and its bound, with its `_plan`
(tile, N tile and passes, ring stages, conv1's share). In float32 also one
TF32 pass, held against its plain version of that mode (allclose 2e-4),
beside its three convs on `F.conv2d` with TF32 on and its bound.

Prints the card's name and power limit, then one JSON line per run and a
summary line. Exits non-zero if a build, a launch or a check fails.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

K2_BATCH = 8
K1_BATCHES = (8, 24)
GRAPH_CALLS = 20
CALL_MAX_HW = 32           # K1's eager call time at 4x4 to 32x32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TF32_FLOPS = 495e12        # dense tensor cores, H100 SXM data sheet
BF16_FLOPS = 989e12


def shapes():
    """(H, Cin, Cout) of the 14 DFBlocks of the 256px generator."""
    ladder = [(256, 256)] * 4 + [(256, 128), (128, 64), (64, 32)]
    out = []
    for i, (cin, cout) in enumerate(ladder):
        out += [(4 * 2 ** i, cin, cout), (4 * 2 ** i, cout, cout)]
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of eager back-to-back calls (CUDA events)."""
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


def graph_ms(fn, calls: int = GRAPH_CALLS, side=None) -> float:
    """Device ms per call: `calls` calls of fn captured in one CUDA graph on
    `side` (a new stream if None), the graph replayed twice between CUDA
    events (after a warm replay)."""
    import torch

    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (2 * calls)


def bound_ms(n_bytes: float, product_s: float) -> float:
    """The least ms of a call: its bytes over HBM or its products' seconds
    on the tensor cores, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, product_s) * 1e3


def build(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from gan_codes_tpu_torch.ops.kernels import _build

    _build.build()


def _held(name, got, want, fp32: bool, tol: float, exp: int) -> float:
    """max|err| of got against want; raises outside fp32 allclose(tol,
    tol) or, in bf16, max|err| <= 2^exp max|ref|."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    ok = (torch.allclose(got, want, atol=tol, rtol=tol) if fp32
          else err <= 2.0 ** exp * top)
    if not ok:
        raise AssertionError(f"{name}: max|err| {err}, max|ref| {top}")
    return err


def _grads_held(name, got, want, share: float) -> None:
    """Each input's gradient within `share` of its max|ref|."""
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        if err > share * top:
            raise AssertionError(f"{name} input {i}: max|err| {err}, "
                                 f"max|ref| {top}")


def _drift(got, ref64) -> float:
    """max|err| / max|ref| of got against a float64 reference."""
    return ((got.double() - ref64).abs().max() / ref64.abs().max()).item()


def _totals(rows) -> dict:
    """The rows' ms summed (`<key>_sum`), their errors and drifts at most."""
    keys = [k for k, v in rows[0].items() if isinstance(v, float)]
    return {f"{k}_sum" if k.endswith("ms") else k:
            (sum if k.endswith("ms") else max)(r[k] for r in rows)
            for k in keys}


def run_k2(root, torch, F, fused_affine, fused_modconv, precision) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
        rows = []
        for hw, cin, cout in shapes():
            if not fused_modconv._supported(
                    torch.empty(3, 3, cin, cout, device="meta")):
                continue

            def rand(*shape, scale=1.0):
                return (torch.randn(*shape, device=dev, generator=gen)
                        * scale).to(dtype)

            x = rand(K2_BATCH, hw, hw, cin)
            vecs = [rand(K2_BATCH, cin) for _ in range(4)]
            w = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
            bias = rand(cout, scale=0.1)
            args = (x, *vecs, w, bias)
            tag = f"{root} K2 {name} {(hw, cin, cout)}"
            out = fused_modconv.fused_modconv3x3(*args)
            ref = fused_modconv.reference_modconv3x3(*args)
            err = _held(tag, out, ref, fp32, 1e-4, -6)
            iters = 20 if hw >= 64 else 50
            h = fused_affine.reference_double_affine_leaky(x, *vecs)
            h_nchw = h.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            calls = {
                "ms": lambda: fused_modconv.fused_modconv3x3(*args),
                "plain_ms": lambda: fused_modconv.reference_modconv3x3(*args),
                "library_ms": lambda: F.conv2d(h_nchw, w_oihw, bias,
                                               padding=1)}
            flops = 2.0 * K2_BATCH * hw * hw * 9 * cin * cout
            n_bytes = (x.numel() + 4 * K2_BATCH * cin + w.numel() + cout
                       + K2_BATCH * hw * hw * cout) * x.element_size()
            row = {"shape": [K2_BATCH, hw, hw, cin, cout], "max_abs_err": err,
                   **{k: cuda_ms(fn, iters) for k, fn in calls.items()},
                   "bound_ms": bound_ms(n_bytes, 3 * flops / TF32_FLOPS
                                        if fp32 else flops / BF16_FLOPS)}
            # the backward: the Function against the plain composition's
            # autograd, as device time. The forwards run on the stream the
            # graph captures on, since autograd runs each backward op on
            # its forward's stream.
            ins = [a.detach().requires_grad_() for a in args]
            dy = rand(K2_BATCH, hw, hw, cout)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                outs = {"bwd_ms": fused_modconv.fused_modconv3x3(*ins),
                        "plain_bwd_ms":
                            fused_modconv.reference_modconv3x3(*ins)}
                got, want = (torch.autograd.grad(o, ins, dy,
                                                 retain_graph=True)
                             for o in outs.values())
                _grads_held(tag + " backward", got, want,
                            1e-3 if fp32 else 2.0 ** -6)
            for k, o in outs.items():
                row[k] = graph_ms(lambda o=o: torch.autograd.grad(
                    o, ins, dy, retain_graph=True), side=side)
            del ins, outs, got, want
            if fp32:
                ref64 = fused_modconv.reference_modconv3x3(
                    *(a.double() for a in args))
                row["drift_vs_float64"] = _drift(out, ref64)
                row["cudnn_drift_vs_float64"] = _drift(ref, ref64)
                del ref64
                previous = precision("high")
                try:
                    row["one_pass_max_abs_err"] = _held(
                        tag + " one pass", calls["ms"](),
                        fused_modconv.reference_modconv3x3(*args, tf32=True),
                        True, 1e-4, 0)
                    row["one_pass_ms"] = cuda_ms(calls["ms"], iters)
                    row["one_pass_library_ms"] = cuda_ms(calls["library_ms"],
                                                         iters)
                finally:
                    precision(previous)
                row["one_pass_bound_ms"] = bound_ms(n_bytes,
                                                    flops / TF32_FLOPS)
            rows.append(row)
            del out, ref, args, calls
            torch.cuda.empty_cache()
        common = [r for r in rows if r["shape"][4] % 64 == 0]
        result[name] = {
            "shapes": rows, "n_shapes": len(rows), **_totals(rows),
            "ms_sum_cout64": sum(r["ms"] for r in common),
            "library_ms_sum_cout64": sum(r["library_ms"] for r in common)}
    return result


def run_k1(root, torch, fused_affine) -> dict:
    """Per-step K1 device time of this root's K2 backward, and of K1's
    forward, per dtype and batch, beside the plain versions."""
    bwd = fused_affine.fused_double_affine_leaky_bwd
    with_z = "want_z" in inspect.signature(bwd).parameters
    kw = {"want_z": True} if with_z else {}
    fwd = fused_affine.fused_double_affine_leaky
    plain_fwd = fused_affine.reference_double_affine_leaky
    plain_bwd = fused_affine.reference_double_affine_leaky_bwd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    counts = {}
    for hw, cin, _ in shapes():
        counts[(hw, cin)] = counts.get((hw, cin), 0) + 1
    result = {"with_z": with_z}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"
        for batch in K1_BATCHES:
            rows = []
            for (hw, c), n in counts.items():
                x, dy = (torch.randn(batch, hw, hw, c, device=dev,
                                     generator=gen).to(dtype)
                         for _ in range(2))
                vecs = [torch.randn(batch, c, device=dev,
                                    generator=gen).to(dtype)
                        for _ in range(4)]
                tag = f"{root} K1 {name} {(batch, hw, hw, c)}"
                ref_f = plain_fwd(x, *vecs)
                ref_b = plain_bwd(x, *vecs, dy)
                out = fwd(x, *vecs)
                _held(tag + " fwd", out, ref_f, fp32, 1e-6, -7)
                got = bwd(x, *vecs, dy, **kw)
                _held(tag + " dx", got[0], ref_b[0], fp32, 1e-6, -7)
                for g, r in zip(got[1:5], ref_b[1:]):
                    _held(tag + " sums", g, r, fp32, 1e-4, -6)
                if with_z and not torch.equal(got[5], out):
                    raise AssertionError(f"{tag}: z != forward")
                fwd_ms = graph_ms(lambda: fwd(x, *vecs))
                bwd_ms = graph_ms(lambda: bwd(x, *vecs, dy, **kw))
                # bytes: the forward 2N (x in, out), the backward 3N (x
                # and dy in, dx out), with z 4N
                big = x.numel() * x.element_size()
                ms = bwd_ms if with_z else fwd_ms + bwd_ms
                bound = bound_ms((4 if with_z else 5) * big, 0)
                row = {"shape": [batch, hw, hw, c], "per_step": n,
                       "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": ms,
                       "bound_ms": bound, "bound_share": bound / ms,
                       "fwd_bound_ms": bound_ms(2 * big, 0),
                       "plain_fwd_ms": cuda_ms(lambda: plain_fwd(x, *vecs),
                                               20),
                       "plain_bwd_ms": cuda_ms(
                           lambda: plain_bwd(x, *vecs, dy, **kw), 20)}
                if hw <= CALL_MAX_HW:
                    # eager back-to-back calls: device time plus what the
                    # wrappers cost the host
                    row["call_ms"] = cuda_ms(
                        (lambda: bwd(x, *vecs, dy, **kw)) if with_z
                        else (lambda: (fwd(x, *vecs), bwd(x, *vecs, dy))),
                        50)
                    row["host_ms"] = row["call_ms"] - ms
                rows.append(row)
                del x, dy, vecs, ref_f, ref_b, out, got
                torch.cuda.empty_cache()
            result[f"{name}_b{batch}"] = {"shapes": rows, **{
                f"step_{k}": sum(r[k] * r["per_step"] for r in rows)
                for k in ("ms", "bound_ms", "fwd_ms", "fwd_bound_ms",
                          "plain_fwd_ms", "plain_bwd_ms")}}
    return result


def resblock_shapes():
    """(H, Cin, Cout) of the 7 residual blocks of the 256px generator."""
    ladder = [(256, 256)] * 4 + [(256, 128), (128, 64), (64, 32)]
    return [(4 * 2 ** i, cin, cout) for i, (cin, cout) in enumerate(ladder)]


def run_k3(root, torch, F, fused_resblock, precision) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4567)
    fr = fused_resblock
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        name = "fp32" if fp32 else "bf16"

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, device=dev, generator=gen)
                    * scale).to(dtype)

        rows = []
        for hw, cin, cout in resblock_shapes():
            sc = cin != cout
            b = K2_BATCH
            args = ([rand(b, hw, hw, cin)]
                    + [rand(b, cin, scale=0.5) for _ in range(4)]
                    + [rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                       rand(cout, scale=0.1)]
                    + [rand(b, cout, scale=0.5) for _ in range(4)]
                    + [rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                       rand(cout, scale=0.1),
                       torch.full((1,), 0.7, device=dev, dtype=dtype)]
                    + ([rand(1, 1, cin, cout, scale=cin ** -0.5),
                        rand(cout, scale=0.1)] if sc else [None, None]))
            tag = f"{root} K3 {name} {(hw, cin, cout)}"
            flops = 2.0 * b * hw * hw * cout * (9 * cin + 9 * cout
                                                + (cin if sc else 0))
            n_bytes = (sum(a.numel() for a in args if a is not None)
                       + b * hw * hw * cout) * args[0].element_size()
            plan = fr._plan(b, hw, hw, cin, cout, dtype, sc)
            calls = {"ms": lambda: fr.fused_resblock_g(*args),
                     "plain_ms": lambda: fr.reference_resblock_g(*args),
                     "composition_ms": lambda: fr._composition(*args)}
            iters = 5 if hw >= 64 else 10
            with torch.no_grad():
                err = _held(tag, calls["ms"](), calls["plain_ms"](), fp32,
                            2e-4, -5)
                row = {"shape": [b, hw, hw, cin, cout], "max_abs_err": err,
                       **{k: cuda_ms(fn, iters) for k, fn in calls.items()},
                       "bound_ms": bound_ms(n_bytes, 3 * flops / TF32_FLOPS
                                            if fp32 else flops / BF16_FLOPS),
                       "plan": {"tile": [plan.th, plan.tw],
                                "n": [plan.nt * 32, plan.n_tiles],
                                "stages": plan.stages,
                                "conv1_share": plan.conv1_share}}
            if fp32:
                # its three convs on cuDNN: conv1 on x, conv2 on an h1,
                # the 1x1 shortcut
                x_nchw = args[0].permute(0, 3, 1, 2)
                h1_nchw = rand(b, cout, hw, hw)
                w1, w2, ws = (None if args[i] is None else
                              args[i].permute(3, 2, 0, 1).contiguous()
                              for i in (5, 11, 14))

                def convs():
                    F.conv2d(x_nchw, w1, args[6], padding=1)
                    F.conv2d(h1_nchw, w2, args[12], padding=1)
                    if sc:
                        F.conv2d(x_nchw, ws, args[15])

                previous = precision("high")
                try:
                    with torch.no_grad():
                        row["one_pass_max_abs_err"] = _held(
                            tag + " one pass", calls["ms"](),
                            fr.reference_resblock_g(*args, tf32=True), True,
                            2e-4, 0)
                        row["one_pass_ms"] = cuda_ms(calls["ms"], iters)
                        row["one_pass_convs_ms"] = cuda_ms(convs, iters)
                finally:
                    precision(previous)
                row["one_pass_bound_ms"] = bound_ms(n_bytes,
                                                    flops / TF32_FLOPS)
            rows.append(row)
            del args, calls
            torch.cuda.empty_cache()
        result[name] = {"shapes": rows, **_totals(rows)}
    return result


def run(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from gan_codes_tpu_torch.ops.kernels import (fused_affine, fused_modconv,
                                                 fused_resblock)
    from gan_codes_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision("highest")  # TF32 off: fp32 runs 3xTF32
    result = {"root": root, "module": fused_modconv.__file__}
    result.update(run_k2(root, torch, F, fused_affine, fused_modconv,
                         set_matmul_precision))
    result["k1"] = run_k1(root, torch, fused_affine)
    result["k3"] = run_k3(root, torch, F, fused_resblock,
                          set_matmul_precision)
    return result


def summary(i: int, root: str, res: dict) -> str:
    """One line: each kernel's sums over its shapes, in ms."""
    k1, k3 = res["k1"], res["k3"]
    k2_32, k3_32 = res["fp32"], k3["fp32"]
    return (f"run {i} {root}: K2 " + "; ".join(
        f"{d} {res[d]['ms_sum']:.4f} over {res[d]['n_shapes']} shapes "
        f"({res[d]['ms_sum_cout64']:.4f} over Cout % 64; plain "
        f"{res[d]['plain_ms_sum']:.4f}, cuDNN {res[d]['library_ms_sum']:.4f}"
        f" ({res[d]['library_ms_sum_cout64']:.4f}), bound "
        f"{res[d]['bound_ms_sum']:.4f}; backward {res[d]['bwd_ms_sum']:.4f}"
        f", plain {res[d]['plain_bwd_ms_sum']:.4f})" for d in ("fp32", "bf16"))
        + f"; one TF32 pass {k2_32['one_pass_ms_sum']:.4f} (cuDNN "
        f"{k2_32['one_pass_library_ms_sum']:.4f}, bound "
        f"{k2_32['one_pass_bound_ms_sum']:.4f}); K1 per step ("
        + ("bwd with z" if k1["with_z"] else "fwd + bwd") + "): "
        + ", ".join(f"{key} {v['step_ms']:.4f} (bound "
                    f"{v['step_bound_ms']:.4f}; forward {v['step_fwd_ms']:.4f}"
                    f", plain {v['step_plain_fwd_ms']:.4f} + "
                    f"{v['step_plain_bwd_ms']:.4f})"
                    for key, v in k1.items() if key != "with_z")
        + "; K3 per 7-block set: " + ", ".join(
            f"{d} {k3[d]['ms_sum']:.4f} (plain {k3[d]['plain_ms_sum']:.4f}, "
            f"composition {k3[d]['composition_ms_sum']:.4f}, bound "
            f"{k3[d]['bound_ms_sum']:.4f}; per shape " + " ".join(
                f"{r['shape'][1]}:{r['ms']:.4f}/{r['composition_ms']:.4f}"
                for r in k3[d]["shapes"]) + ")" for d in ("fp32", "bf16"))
        + f", one TF32 pass {k3_32['one_pass_ms_sum']:.4f} (its convs on "
        f"cuDNN {k3_32['one_pass_convs_ms_sum']:.4f}, bound "
        f"{k3_32['one_pass_bound_ms_sum']:.4f})")


def main(argv) -> int:
    if len(argv) == 2 and argv[0] in ("--build", "--one"):
        if argv[0] == "--build":
            build(argv[1])
        else:
            print(json.dumps(run(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in dict.fromkeys(argv)]
    if any(p.wait() != 0 for p in builds):
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for i, root in enumerate(argv):
        proc = subprocess.run([sys.executable, me, "--one", root],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["run"] = i
        print(json.dumps(res), flush=True)
        print(summary(i, root, res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

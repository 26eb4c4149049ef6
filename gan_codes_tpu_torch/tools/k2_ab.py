#!/usr/bin/env python3
"""K2 (`fused_modconv3x3`, forward) of several trees, timed on one card.

    python3 gan_codes_tpu_torch/tools/k2_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository (for example
the parent commit unpacked with `git archive` into a directory that
.gitignore lists). Every root's kernels are built first, all at once, each
into its own `gan_codes_tpu_torch/_build/`; then each root, in the order
given, runs in a process of its own: its `fused_modconv3x3` at every
DFBlock of the 256px generator (n_channels 32) that its `_supported`
takes, batch 8, float32 (TF32 off) and bfloat16, checked against its own
plain version (fp32 allclose 1e-4; bf16 max|err| <= 2^-6 max|ref|) and
timed with CUDA events (mean of 20 calls after 3 warm ones, 50 below
64x64), with cuDNN's `F.conv2d` of the modulated input in the same dtype
beside it. Giving a root twice, in the order parent, change, change,
parent, shows the spread between runs of one tree.

Prints the card's name and power limit, then one JSON line per run: the
times per shape and their sums over all the shapes the root takes and
over the 12 of Cout % 64 == 0 (the shapes every version of K2 takes).
Exits non-zero if a build, a launch or a check fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

BATCH = 8


def shapes():
    """(H, Cin, Cout) of the 14 DFBlocks of the 256px generator."""
    ladder = [(256, 256)] * 4 + [(256, 128), (128, 64), (64, 32)]
    out = []
    for i, (cin, cout) in enumerate(ladder):
        out += [(4 * 2 ** i, cin, cout), (4 * 2 ** i, cout, cout)]
    return out


def cuda_ms(fn, iters: int) -> float:
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


def build(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from gan_codes_tpu_torch.ops.kernels import _build

    _build.build()


def run(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    result = {"root": root, "module": fused_modconv.__file__}
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        rows = []
        for hw, cin, cout in shapes():
            if not fused_modconv._supported(
                    torch.empty(3, 3, cin, cout, device="meta")):
                continue

            def rand(*shape, scale=1.0):
                return (torch.randn(*shape, device=dev, generator=gen)
                        * scale).to(dtype)

            x = rand(BATCH, hw, hw, cin)
            vecs = [rand(BATCH, cin) for _ in range(4)]
            w = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
            bias = rand(cout, scale=0.1)
            args = (x, *vecs, w, bias)
            out = fused_modconv.fused_modconv3x3(*args)
            ref = fused_modconv.reference_modconv3x3(*args)
            err = (out.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            ok = (torch.allclose(out, ref, atol=1e-4, rtol=1e-4)
                  if dtype == torch.float32 else err <= 2.0 ** -6 * top)
            if not ok:
                raise AssertionError(f"{root} K2 {name} {(hw, cin, cout)}: "
                                     f"max|err| {err}, max|ref| {top}")
            iters = 20 if hw >= 64 else 50
            ms = cuda_ms(lambda: fused_modconv.fused_modconv3x3(*args),
                         iters)
            h = fused_affine.reference_double_affine_leaky(x, *vecs)
            h_nchw = h.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            lib = cuda_ms(lambda: F.conv2d(h_nchw, w_oihw, bias, padding=1),
                          iters)
            rows.append({"shape": [BATCH, hw, hw, cin, cout], "ms": ms,
                         "library_ms": lib, "max_abs_err": err})
        common = [r for r in rows if r["shape"][4] % 64 == 0]
        result[name] = {
            "shapes": rows, "n_shapes": len(rows),
            "ms_sum": sum(r["ms"] for r in rows),
            "library_ms_sum": sum(r["library_ms"] for r in rows),
            "ms_sum_cout64": sum(r["ms"] for r in common),
            "library_ms_sum_cout64": sum(r["library_ms"] for r in common)}
    return result


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
        print(f"run {i} {root}: " + "; ".join(
            f"{d} K2 {res[d]['ms_sum']:.4f} ms over {res[d]['n_shapes']} "
            f"shapes ({res[d]['ms_sum_cout64']:.4f} over Cout % 64), "
            f"cuDNN {res[d]['library_ms_sum']:.4f} "
            f"({res[d]['library_ms_sum_cout64']:.4f})"
            for d in ("fp32", "bf16")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

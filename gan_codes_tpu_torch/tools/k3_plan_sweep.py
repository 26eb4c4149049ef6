#!/usr/bin/env python3
"""K3 (`fused_resblock_g`) under several of `_plan`'s candidate tilings per
shape, timed on one card: the data that `_plan`'s time model is fitted to.

    python3 gan_codes_tpu_torch/tools/k3_plan_sweep.py > k3_sweep.jsonl
    python3 gan_codes_tpu_torch/tools/k3_plan_sweep.py --fit k3_sweep.jsonl

At the 7 residual blocks of the 256px generator (n_channels 32), batch 8,
float32 (TF32 off) and bfloat16: the tiling `_plan` takes, and per N tile
the two its model ranks first, the first of at most 132 blocks, the first
with at least 6 conv1 m64 tiles and the largest tile. Each is checked
against the plain version (fp32 allclose 2e-4; bf16 max|err| <= 2^-5
max|ref|) and timed with CUDA events around eager calls (mean of 5 after
2 warm ones), with the composition beside it; one JSON line each.

`--fit FILE` (no card needed) grid-searches the constants of `_plan`'s
time model (`fused_resblock._seconds`) per dtype (tensor-core efficiency,
a chunk's fixed cost, an A-build round, a tap, an epilogue's N tile) for
the least squared log error over FILE's lines, and prints them: the
source of `fused_resblock.MODEL`.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import sys

SHAPES = [(4, 256, 256), (8, 256, 256), (16, 256, 256), (32, 256, 256),
          (64, 256, 128), (128, 128, 64), (256, 64, 32)]
BATCH = 8


def cuda_ms(torch, fn, iters: int = 5) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sweep() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_resblock as fr

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    chosen = fr._plan
    for dtype in (torch.float32, torch.bfloat16):
        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, device=dev, generator=gen)
                    * scale).to(dtype)

        for hw, cin, cout in SHAPES:
            b, sc = BATCH, cin != cout
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
            ref = fr.reference_resblock_g(*args)
            top = ref.float().abs().max().item()
            cands = sorted(fr._candidates(b, hw, hw, cin, cout, dtype, sc),
                           key=lambda tp: tp[0])
            model = {p: t for t, p in cands}
            picks = [chosen(b, hw, hw, cin, cout, dtype, sc)]
            for nt in (1, 2, 4, 8):
                c = [p for _, p in cands if p.nt == nt]
                picks += c[:2] + [p for p in c if p.blocks <= 132][:1]
                picks += [p for p in c if p.m1 >= 6][:1]
                picks += sorted(c, key=lambda p: -p.th * p.tw)[:1]
            with torch.no_grad():
                comp = cuda_ms(torch, lambda: fr._composition(*args))
                for p in dict.fromkeys(picks):
                    fr._plan = lambda *a, p=p: p
                    try:
                        out = fr.fused_resblock_g(*args)
                        err = (out.float() - ref.float()).abs().max().item()
                        ok = (torch.allclose(out, ref, atol=2e-4, rtol=2e-4)
                              if dtype == torch.float32
                              else err <= 2.0 ** -5 * top)
                        if not ok:
                            raise AssertionError(f"{dtype} {hw} {p}: "
                                                 f"max|err| {err}")
                        ms = cuda_ms(torch,
                                     lambda: fr.fused_resblock_g(*args))
                    finally:
                        fr._plan = chosen
                    print(json.dumps(dict(
                        dtype=str(dtype), shape=[hw, cin, cout],
                        chosen=p == picks[0], model_ms=model[p] * 1e3,
                        ms=ms, comp_ms=comp, max_abs_err=err,
                        **p._asdict())), flush=True)


def fit(path: str) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from gan_codes_tpu_torch.ops.kernels import fused_resblock as fr

    rows = [json.loads(line) for line in open(path) if line.strip()]
    fields = fr.Plan._fields

    def model_ms(r, c):
        plan = fr.Plan(*(r[f] for f in fields))
        dtype = getattr(torch, r["dtype"].split(".")[-1])
        return fr._seconds(plan, r["shape"][1] != r["shape"][2], dtype,
                           c) * 1e3

    grid = dict(eff=[0.15, 0.2, 0.3, 0.4, 0.5, 0.6],
                chunk=[0, 0.5e-6, 1e-6, 2e-6, 3e-6],
                build=[0, 0.5e-6, 1e-6, 2e-6, 3e-6, 4e-6],
                tap=[0, 0.1e-6, 0.2e-6], epi=[0, 1e-6, 2e-6, 4e-6])
    for dtype in sorted({r["dtype"] for r in rows}):
        sub = [r for r in rows if r["dtype"] == dtype]
        best = min(((sum(math.log(model_ms(r, c) / r["ms"]) ** 2
                         for r in sub), c)
                    for c in (dict(zip(grid, v))
                              for v in itertools.product(*grid.values()))),
                   key=lambda ec: ec[0])
        print(json.dumps({"dtype": dtype, "lines": len(sub),
                          "squared_log_error": best[0], **best[1]}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fit"]:
        fit(sys.argv[2])
    else:
        sweep()

#!/usr/bin/env python3
"""The generator kernels of several trees, timed on one card: K2
(`fused_modconv3x3`, forward), K1 (`fused_double_affine_leaky` and its
backward) as a train step runs them, and K3 (`fused_resblock_g`, forward).

    python3 gan_codes_tpu_torch/tools/kernel_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository (for example
the parent commit unpacked with `git archive` into a directory that
.gitignore lists). Every root's kernels are built first, all at once, each
into its own `gan_codes_tpu_torch/_build/`; then each root, in the order
given, runs in a process of its own. Giving a root twice, in the order
parent, change, change, parent, shows the spread between runs of one tree.

K2: its `fused_modconv3x3` at every DFBlock of the 256px generator
(n_channels 32) that its `_supported` takes, batch 8, float32 (TF32 off)
and bfloat16, checked against its own plain version (fp32 allclose 1e-4;
bf16 max|err| <= 2^-6 max|ref|) and timed with CUDA events around eager
calls (mean of 20 calls after 3 warm ones, 50 below 64x64), with cuDNN's
`F.conv2d` of the modulated input in the same dtype beside it.

K1: what one train step's backward runs of it at the 14 DFBlock inputs of
that generator (10 distinct shapes), at batch 8 and 24, float32 and
bfloat16. Where the root's `fused_double_affine_leaky_bwd` takes `want_z`,
K2's backward runs one K1 backward that also writes h: that call is timed.
Otherwise (the trees before it) K2's backward runs K1's forward, then K1's
backward: both are timed and added. Each call is checked against the
root's plain versions (forward and dx fp32 allclose 1e-6, bf16 within
2^-7 max|ref|; the four sums fp32 allclose 1e-4, bf16 within 2^-6
max|ref|; z equal to the forward bit for bit) and timed as device time:
GRAPH_CALLS calls captured in one CUDA graph, its replay timed with CUDA
events. The sum over the 14 DFBlocks is the per-step K1 device time. At
4x4 to 32x32 the same calls also run eagerly back to back (CUDA events):
`call_ms`, and `host_ms` = call_ms - device ms, the wrappers' host cost.

K3: its `fused_resblock_g` at the 7 residual blocks of the 256px generator,
batch 8, float32 (TF32 off) and bfloat16, checked against its own plain
version (fp32 allclose 2e-4; bf16 max|err| <= 2^-5 max|ref|) and timed
with CUDA events around eager calls (mean of 5 calls after 2 warm ones, 10
below 64x64), with the composition beside it (`_composition`: the port's
way to compute the block from K2, cuDNN's 1x1 and torch ops) and the bound
by route (fp32: 3xTF32, three products a product, over 495 TFLOP/s; bf16:
over 989 TFLOP/s).

Prints the card's name and power limit, then one JSON line per run and a
summary line. Exits non-zero if a build, a launch or a check fails.

    python3 gan_codes_tpu_torch/tools/kernel_ab.py --steps PARENT . . PARENT

instead runs, for each root, the fp32 train step of its `chip_smoke.py`
(256px, batch 24, the seeded state of `_train_setup`) through its kernels
and through its plain versions, four times each way: G's fakes, the
phase-1 D gradients from them (and from one fakes tensor twice, D's own
spread), the whole step from the fresh state and from one shared state a
kernels step on. One JSON line per comparison: max|err| against max|ref|,
the D gradient elements under 1e-7, the elements whose first Adam update
(beta1 0: lr * g / (|g| + eps)) lands over lr/4 apart, and the losses'
relative gaps, and the G gradients after the step; then each root's fakes
and phase-1 D gradients (kernels) against the first root's.
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


def graph_ms(fn, calls: int = GRAPH_CALLS) -> float:
    """Device ms per call: `calls` calls of fn captured in one CUDA graph,
    the graph replayed twice between CUDA events (after a warm replay)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def run_k2(root, torch, F, fused_affine, fused_modconv) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    result = {}
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

            x = rand(K2_BATCH, hw, hw, cin)
            vecs = [rand(K2_BATCH, cin) for _ in range(4)]
            w = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
            bias = rand(cout, scale=0.1)
            args = (x, *vecs, w, bias)
            out = fused_modconv.fused_modconv3x3(*args)
            ref = fused_modconv.reference_modconv3x3(*args)
            err = _held(f"{root} K2 {name} {(hw, cin, cout)}", out, ref,
                        dtype == torch.float32, 1e-4, -6)
            iters = 20 if hw >= 64 else 50
            ms = cuda_ms(lambda: fused_modconv.fused_modconv3x3(*args),
                         iters)
            h = fused_affine.reference_double_affine_leaky(x, *vecs)
            h_nchw = h.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            lib = cuda_ms(lambda: F.conv2d(h_nchw, w_oihw, bias, padding=1),
                          iters)
            rows.append({"shape": [K2_BATCH, hw, hw, cin, cout], "ms": ms,
                         "library_ms": lib, "max_abs_err": err})
        common = [r for r in rows if r["shape"][4] % 64 == 0]
        result[name] = {
            "shapes": rows, "n_shapes": len(rows),
            "ms_sum": sum(r["ms"] for r in rows),
            "library_ms_sum": sum(r["library_ms"] for r in rows),
            "ms_sum_cout64": sum(r["ms"] for r in common),
            "library_ms_sum_cout64": sum(r["library_ms"] for r in common)}
    return result


def run_k1(root, torch, fused_affine) -> dict:
    """Per-step K1 device time of this root's K2 backward, per dtype and
    batch."""
    bwd = fused_affine.fused_double_affine_leaky_bwd
    with_z = "want_z" in inspect.signature(bwd).parameters
    fwd = fused_affine.fused_double_affine_leaky
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
                ref_f = fused_affine.reference_double_affine_leaky(x, *vecs)
                ref_b = fused_affine.reference_double_affine_leaky_bwd(
                    x, *vecs, dy)
                out = fwd(x, *vecs)
                _held(tag + " fwd", out, ref_f, fp32, 1e-6, -7)
                got = (bwd(x, *vecs, dy, want_z=True) if with_z
                       else bwd(x, *vecs, dy))
                _held(tag + " dx", got[0], ref_b[0], fp32, 1e-6, -7)
                for g, r in zip(got[1:5], ref_b[1:]):
                    _held(tag + " sums", g, r, fp32, 1e-4, -6)
                if with_z:
                    if not torch.equal(got[5], out):
                        raise AssertionError(f"{tag}: z != forward")
                    bwd_ms = graph_ms(lambda: bwd(x, *vecs, dy, want_z=True))
                    fwd_ms = 0.0
                    n_bytes = 4 * x.numel() * x.element_size()
                else:
                    bwd_ms = graph_ms(lambda: bwd(x, *vecs, dy))
                    fwd_ms = graph_ms(lambda: fwd(x, *vecs))
                    n_bytes = 5 * x.numel() * x.element_size()
                ms = fwd_ms + bwd_ms
                bound = n_bytes / HBM_BYTES_PER_S * 1e3
                row = {"shape": [batch, hw, hw, c], "per_step": n,
                       "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": ms,
                       "bound_ms": bound, "bound_share": bound / ms,
                       "gb_per_s": n_bytes / ms / 1e6}
                if hw <= CALL_MAX_HW:
                    # eager back-to-back calls: device time plus what the
                    # wrappers cost the host
                    row["call_ms"] = cuda_ms(
                        (lambda: bwd(x, *vecs, dy, want_z=True)) if with_z
                        else (lambda: (fwd(x, *vecs), bwd(x, *vecs, dy))),
                        50)
                    row["host_ms"] = row["call_ms"] - ms
                rows.append(row)
                del x, dy, vecs, ref_f, ref_b, out, got
                torch.cuda.empty_cache()
            result[f"{name}_b{batch}"] = {
                "shapes": rows,
                "step_ms": sum(r["ms"] * r["per_step"] for r in rows),
                "step_bound_ms": sum(r["bound_ms"] * r["per_step"]
                                     for r in rows)}
    return result


def resblock_shapes():
    """(H, Cin, Cout) of the 7 residual blocks of the 256px generator."""
    ladder = [(256, 256)] * 4 + [(256, 128), (128, 64), (64, 32)]
    return [(4 * 2 ** i, cin, cout) for i, (cin, cout) in enumerate(ladder)]


def run_k3(root, torch, fused_resblock) -> dict:
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
            with torch.no_grad():
                out = fr.fused_resblock_g(*args)
                ref = fr.reference_resblock_g(*args)
                err = _held(f"{root} K3 {name} {(hw, cin, cout)}", out, ref,
                            fp32, 2e-4, -5)
                del out, ref
                iters = 5 if hw >= 64 else 10
                ms = cuda_ms(lambda: fr.fused_resblock_g(*args), iters)
                comp = cuda_ms(lambda: fr._composition(*args), iters)
            flops = 2.0 * b * hw * hw * cout * (9 * cin + 9 * cout
                                                + (cin if sc else 0))
            bound = (3 * flops / TF32_FLOPS if fp32
                     else flops / BF16_FLOPS) * 1e3
            rows.append({"shape": [b, hw, hw, cin, cout], "ms": ms,
                         "composition_ms": comp, "bound_ms": bound,
                         "max_abs_err": err})
            del args
            torch.cuda.empty_cache()
        result[name] = {"shapes": rows,
                        "ms_sum": sum(r["ms"] for r in rows),
                        "composition_ms_sum": sum(r["composition_ms"]
                                                  for r in rows),
                        "bound_ms_sum": sum(r["bound_ms"] for r in rows)}
    return result


def run(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from gan_codes_tpu_torch.ops.kernels import (fused_affine, fused_modconv,
                                                 fused_resblock)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"root": root, "module": fused_modconv.__file__}
    result.update(run_k2(root, torch, F, fused_affine, fused_modconv))
    result["k1"] = run_k1(root, torch, fused_affine)
    result["k3"] = run_k3(root, torch, fused_resblock)
    return result


def _adam_moves(g_a, g_b, lr: float, eps: float) -> int:
    """Elements whose first Adam update (beta1 0: lr * g / (|g| + eps))
    lands more than lr / 4 apart between gradients g_a and g_b."""
    return sum(int(((a / (a.abs() + eps) - b / (b.abs() + eps)).abs()
                    * lr > lr / 4).sum()) for a, b in zip(g_a, g_b))


def _gap(got, want) -> dict:
    """max|err| over a list of tensors against max|ref| among them."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    top = max(w.abs().max().item() for w in want)
    return {"max_err": err, "max_ref": top, "ratio": err / top}


def run_steps(root: str, out_path: str) -> list:
    """The fp32 train step of `chip_smoke._train_setup` (256px, batch 24),
    through the root's kernels and through its plain versions
    (`chip_smoke._plain_or_kernels`), four times each way in the order
    kernels, plain: G's fakes (autograd on, as the step makes them), the
    phase-1 D gradients from them, those gradients again from the first
    kernels run's fakes (D's own spread), and the whole step from the
    fresh state and from one shared state one kernels step on. Saves the
    first fakes of each way, and the first kernels run's D gradients, to
    out_path."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import torch

    from gan_codes_tpu_torch.train import losses
    from gan_codes_tpu_torch.train.checkpoint import (load_state_dict,
                                                      state_to_dict)
    from gan_codes_tpu_torch.utils.device import serving_device

    serving_device("cuda")
    cfg, state, te, step, (images, captions, cap_lens) = cs._train_setup(
        "float32")
    lr, eps = cfg.optim.d_lr, cfg.optim.eps
    noise = torch.randn((cs.TRAIN_BATCH, cfg.generator.latent_dim),
                        generator=torch.Generator(device="cuda"
                                                  ).manual_seed(cs.SEED),
                        device="cuda")
    with torch.no_grad():
        sents = te(captions, cap_lens).float()
    d_params = list(state.discriminator.parameters())

    def d_grads(fake):
        loss = losses.d_hinge_loss(state.discriminator, images, fake, sents)
        return [g.detach().clone()
                for g in torch.autograd.grad(loss, d_params)]

    fakes, grads = {False: [], True: []}, {False: [], True: []}
    for plain in (False, True) * 4:
        fake = cs._plain_or_kernels(
            plain, lambda: state.generator(noise, sents)).detach()
        fakes[plain].append(fake)
        grads[plain].append(d_grads(fake))
    own = d_grads(fakes[False][0])
    rows = [{"root": root, "what": "fakes", "pair": pair, **_gap(a, b)}
            for pair, a, b in (
                ("kernels_vs_kernels", fakes[False][1:], fakes[False][:3]),
                ("plain_vs_plain", fakes[True][1:], fakes[True][:3]),
                ("kernels_vs_plain", fakes[False], fakes[True]))]
    k, p = grads[False], grads[True]
    for pair, a, b in (("same_fakes", own, k[0]),
                       ("kernels_vs_kernels", k[1], k[0]),
                       ("plain_vs_plain", p[1], p[0]),
                       ("kernels_vs_plain", k[0], p[0])):
        rows.append({"root": root, "what": "phase1_d_grads", "pair": pair,
                     **_gap(a, b), "adam_moves_over_lr_4":
                     _adam_moves(a, b, lr, eps),
                     "elements_under_1e-7": sum(
                         int((x.abs() < 1e-7).sum()) for x in b),
                     "elements": sum(x.numel() for x in b)})
    torch.save({"kernels": fakes[False][0].cpu(),
                "plain": fakes[True][0].cpu(),
                "d_grads": [g.cpu() for g in grads[False][0]],
                "lr": lr, "eps": eps}, out_path)
    del fakes, grads, k, p, own, state, step

    _, state, te, step, batch = cs._train_setup("float32")
    step(state, te, *batch, noise=noise)
    warm = cs._snapshot(state_to_dict(state))
    del state
    for which in ("first", "second"):
        runs = []
        for plain in (False, True, False, True):
            _, state, te, step, batch = cs._train_setup("float32")
            if which == "second":
                load_state_dict(state, cs._snapshot(warm))
            m = cs._plain_or_kernels(plain, lambda: step(state, te, *batch,
                                                         noise=noise))
            runs.append(({k: m[k].item() for k in
                          ("d_loss", "d_gp_loss", "g_loss")},
                         [p.detach().clone() for p in
                          state.discriminator.parameters()],
                         [p.grad.detach().clone() for p in
                          state.generator.parameters()]))
            del state, step
        for (i, j), pair in (((2, 0), "kernels_vs_kernels"),
                             ((3, 1), "plain_vs_plain"),
                             ((0, 1), "kernels_vs_plain")):
            (li, di, gi), (lj, dj, gj) = runs[i], runs[j]
            rows.append({"root": root, "what": f"step_{which}", "pair": pair,
                         "losses": [li, lj],
                         "rel_gap": {k: abs(li[k] - lj[k]) / abs(lj[k])
                                     for k in li},
                         "d_params_over_lr_4": sum(
                             int(((a - b).abs() > lr / 4).sum())
                             for a, b in zip(di, dj)),
                         "g_grads": _gap(gi, gj)})
    return rows


def steps(roots) -> int:
    """`--steps ROOT...`: run_steps for each root in a process of its own,
    then each root's first fakes against the first root's."""
    import tempfile

    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as out_dir:
        paths = [os.path.join(out_dir, f"fakes_{i}.pt")
                 for i in range(len(roots))]
        for root, path in zip(roots, paths):
            proc = subprocess.run([sys.executable, me, "--one-steps", root,
                                   path], capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                return proc.returncode
            print(proc.stdout.strip(), flush=True)
        import torch

        first = torch.load(paths[0])
        for root, path in zip(roots[1:], paths[1:]):
            other = torch.load(path)
            print(json.dumps({"root": os.path.abspath(root),
                              "what": "against_first_root", **{
                                  f"fakes_{way}": _gap([other[way]],
                                                       [first[way]])
                                  for way in ("kernels", "plain")},
                              "phase1_d_grads_kernels": {
                                  **_gap(other["d_grads"], first["d_grads"]),
                                  "adam_moves_over_lr_4": _adam_moves(
                                      other["d_grads"], first["d_grads"],
                                      first["lr"], first["eps"])}}),
                  flush=True)
    return 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] in ("--build", "--one"):
        if argv[0] == "--build":
            build(argv[1])
        else:
            print(json.dumps(run(argv[1])), flush=True)
        return 0
    if len(argv) == 3 and argv[0] == "--one-steps":
        for row in run_steps(argv[1], argv[2]):
            print(json.dumps(row), flush=True)
        return 0
    if not argv or argv == ["--steps"]:
        print(__doc__, file=sys.stderr)
        return 2
    roots = argv[1:] if argv[0] == "--steps" else argv
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in dict.fromkeys(roots)]
    if any(p.wait() != 0 for p in builds):
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if argv[0] == "--steps":
        return steps(roots)
    for i, root in enumerate(argv):
        proc = subprocess.run([sys.executable, me, "--one", root],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["run"] = i
        print(json.dumps(res), flush=True)
        k1 = res["k1"]
        print(f"run {i} {root}: " + "; ".join(
            f"{d} K2 {res[d]['ms_sum']:.4f} ms over {res[d]['n_shapes']} "
            f"shapes ({res[d]['ms_sum_cout64']:.4f} over Cout % 64), "
            f"cuDNN {res[d]['library_ms_sum']:.4f} "
            f"({res[d]['library_ms_sum_cout64']:.4f})"
            for d in ("fp32", "bf16")) + "; K1 per step ("
            + ("bwd with z" if k1["with_z"] else "fwd + bwd") + "): "
            + ", ".join(f"{key} {v['step_ms']:.4f} ms (bound "
                        f"{v['step_bound_ms']:.4f})"
                        for key, v in k1.items() if key != "with_z")
            + "; K3 per 7-block set: " + ", ".join(
                f"{d} {res['k3'][d]['ms_sum']:.4f} ms (composition "
                f"{res['k3'][d]['composition_ms_sum']:.4f}, bound "
                f"{res['k3'][d]['bound_ms_sum']:.4f}; per shape "
                + " ".join(f"{r['shape'][1]}:{r['ms']:.4f}/"
                           f"{r['composition_ms']:.4f}"
                           for r in res["k3"][d]["shapes"]) + ")"
                for d in ("fp32", "bf16")),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

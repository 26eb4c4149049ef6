"""Offline generation: `Sampler.generate_tokens` back to back (closed
loop), each call `batch` fresh captions from the seed, float32 images
back on the host, as `generate.py` and `sample.py` use it.

Set-up builds the Sampler on the seed's weights and warms it (its
throwaway warm-up batch, then one call); the window calls it until
`--seconds` have passed, and the rate is the images returned over the
window's wall time. A sample of the calls, drawn from the seed, keeps its
captions and images for the reference, which follows the Sampler's noise
stream (one [batch, latent] draw per call from a generator seeded as the
Sampler's); `failed` counts the checked calls with a non-finite image.
With `--trace 1`, `trace_calls` calls a third of the way in run under
the profiler.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from .. import checks, core, weights, workgen
from ..reference import dfgan
from ..trace import Trace, profiler, warm_profiler
from . import common


def run(ctx: core.Context) -> core.Window:
    from gan_codes_tpu_torch.models.generator import Generator
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.serve import Sampler

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    common.set_precision(cfg)
    pcfg = common.port_config(cfg)
    g = Generator(pcfg.generator).to(dev)
    g.load_state_dict(weights.make(cfg, "generator", ctx.seed, dev))
    te = RNNEncoder(pcfg.text_encoder).to(dev)
    te.load_state_dict(weights.make(cfg, "text_encoder", ctx.seed, dev))
    batch = int(mix["batch"])
    noise_seed = workgen.torch_seed(ctx.seed, "generate.noise")
    sampler = Sampler(pcfg, g, te, batch_size=batch, seed=noise_seed,
                      device=dev)
    t = cfg["text_encoder"]
    caps_rng = workgen.rng(ctx.seed, "generate.captions")

    def next_batch():
        return workgen.token_batch(caps_rng, batch, t["vocab_size"],
                                   t["max_len"], mix["caption_words"])

    sampler.warmup()
    sampler.generate_tokens(*workgen.token_batch(
        workgen.rng(ctx.seed, "generate.warmup"), batch, t["vocab_size"],
        t["max_len"], mix["caption_words"]))
    common.sync(dev)
    if ctx.trace:
        warm_profiler()
    pick = workgen.rng(ctx.seed, "generate.sample")
    keep_n = int(ctx.cell_file["sample_calls"])
    kept = []      # (draw index, captions, lengths, images): a reservoir
    calls = 0
    done: List[float] = []  # when each call returned
    prof = None

    def call():
        nonlocal calls
        caps, lens = next_batch()
        imgs = sampler.generate_tokens(caps, lens)
        calls += 1  # this call's noise is the Sampler's draw `calls`
        done.append(time.perf_counter())
        item = (calls, caps, lens, imgs)
        if len(kept) < keep_n:
            kept.append(item)
        else:
            j = int(pick.integers(0, calls))
            if j < keep_n:
                kept[j] = item

    ctx.start_window()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    if ctx.trace:
        while time.perf_counter() < t0 + ctx.seconds / 3:
            call()
        n = int(ctx.cell_file["trace_calls"])
        prof = profiler()
        with prof:
            for _ in range(n):
                call()
    while time.perf_counter() < deadline:
        call()
    elapsed = time.perf_counter() - t0
    ctx.end_window()
    ctx.log(f"[gen] window: {calls} calls in {elapsed:.3f} s; img/s by "
            "third " + " / ".join(f"{batch * r:.1f}" for r in
                                  core.thirds(done, t0, elapsed)))
    trace = Trace(prof, int(ctx.cell_file["trace_calls"])) if prof else None
    failed = sum(not np.isfinite(item[3]).all() for item in kept)
    peak = common.memory_peak(dev)
    del sampler, g, te
    common.free(dev)

    refs = images(ctx, noise_seed, [item[:3] for item in kept])
    gaps = image_checks([item[3] for item in kept], refs)
    return core.Window(
        e2e={"gen_img_per_s": calls * batch / elapsed}, attempted=calls,
        failed=failed, program={"calls": calls}, trace=trace,
        memory_peak_bytes=peak, checks=gaps, seconds=elapsed)


def image_checks(prog, ref) -> Dict[str, float]:
    """The widest and the root-mean-square difference over all the
    images of the checked calls."""
    d = [checks.image_gaps(p, r) for p, r in zip(prog, ref)]
    size = [p.size for p in prog]
    return {"img_max_abs": max(x["img_max_abs"] for x in d),
            "img_rms": float(np.sqrt(sum(x["img_rms"] ** 2 * n
                                         for x, n in zip(d, size))
                                     / sum(size)))}


@torch.no_grad()
def images(ctx: core.Context, noise_seed: int, items,
           precision=common.reference_precision, autocast=None):
    """The reference's images (NHWC float32, host) of each (draw index,
    captions, lengths) in `items`, the draw being the Sampler's."""
    cfg, dev = ctx.cfg, ctx.device
    precision()
    gp = weights.make(cfg, "generator", ctx.seed, dev)
    tp = weights.make(cfg, "text_encoder", ctx.seed, dev)
    rng = torch.Generator(device=dev).manual_seed(noise_seed)
    batch = int(ctx.mix["batch"])
    z = cfg["generator"]["latent_dim"]
    draws = [torch.randn((batch, z), generator=rng, device=dev)
             for _ in range(max((k for k, _, _ in items), default=-1) + 1)]
    out = []
    for k, caps, lens in items:
        with autocast() if autocast else contextlib.nullcontext():
            s = dfgan.text_encode(tp, torch.from_numpy(caps).to(dev),
                                  torch.from_numpy(lens))
            img = dfgan.generator(gp, draws[k], s)
        out.append(img.float().permute(0, 2, 3, 1).cpu().numpy())
    return out

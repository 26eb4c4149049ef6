"""GALIP training: `Trainer.train_epoch` over the port's `DataLoader` on a
CUB-layout tree written from the seed, as `drivers/train.py` drives
DF-GAN: the same feed (`Feed`), the same traced block (`StepTracer`),
the rate the window's images over its wall time.

Set-up writes the tree (captions as ids over CLIP's vocabulary, framed by
the dataset to 77 tokens), builds the frozen CLIP, G and D + C on the
seed's weights (`weights_galip.py`) and one `Trainer`, and runs the first
three steps, each a `train_epoch` call on the window's feed: the warm-up,
and what the reference follows. Before the first step it reads the text
tower's sentences and G's images on the first batch with the step's own
noise draw.

`correct` compares, with the plain reference (`reference/galip.py`, fp32
with TF32 off) on the same weights, batches and random stream:
`sent_gap` (the text tower's sentences, widest difference over the
widest sentence value), `img_gap` (the first G forward's images, widest
difference), `loss_gap` (the first step's D loss, before any update),
`grad_gap_d` / `grad_gap_g` (each optimizer's first gradient, by leaf,
read from Adam's first moment, beta1 = 0; the worst leaf, `*_median` the
median one), `change_gap_d` / `change_gap_g` / `change_gap_ema` (each
module's change after the three steps, the median leaf; `*_worst` the
worst one) and `change1_gap_ema` (the EMA of G's change over the first
step, the median leaf: the EMA updated from the new G at its decay;
`change1_gap_g` G's own, the worst leaf); the cell's file holds some.

    python3 h100_bench/drivers/galip_train.py --controls --seeds 11,12

prints, a seed a line, the same readings with the reference in the
program's place computed in bfloat16 (`control`), on half the batch
(`half_batch`), with its EMA at decay 0.99 (`ema_decay`): the other side
of each limit; and with the reference at one TF32 pass (`tf32`), a second
witness of what the program's precision alone moves.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100_bench import (checks, core, spec as spec_mod,  # noqa: E402
                        weights_galip, workgen)
from h100_bench.drivers import common  # noqa: E402
from h100_bench.drivers.train import (REF_STEPS, Feed, StepTracer,  # noqa
                                      _host, _norms, first_change)
from h100_bench.reference import galip as ref  # noqa: E402
from h100_bench.trace import warm_profiler  # noqa: E402


def port_config(cfg: dict):
    """The port's `GALIPConfig` for a benchmark configuration (the file
    keeps the config's own keys)."""
    from gan_codes_tpu_torch.config import GALIPConfig

    return GALIPConfig.from_dict(cfg)


def write_tree(ctx: core.Context) -> str:
    tree = os.path.join(ctx.workdir, "cub")
    workgen.write_cub_tree(tree, ctx.seed, ctx.mix,
                           int(ctx.mix["caption_ids"]))
    return tree


def first_gradients(state) -> Dict[str, float]:
    """Norms by leaf of each optimizer's first gradient, from Adam's
    first moment after one step (beta1 = 0): G's as "g.", D + C's as
    "d."."""
    out = {}
    for prefix, module, opt in (("g.", state.generator, state.g_opt),
                                ("d.", state.discriminator, state.d_opt)):
        for (n, _), p in zip(module.named_parameters(), opt.params):
            st = opt.adam.state.get(p, {})
            out[prefix + n] = st["exp_avg"] if st else torch.zeros_like(p)
    return _norms(out)


def run(ctx: core.Context) -> core.Window:
    # the port's GALIP first: a program without it fails here, at once
    from gan_codes_tpu_torch.models import galip as _galip  # noqa: F401
    from gan_codes_tpu_torch.data.dataset import CUBDataset
    from gan_codes_tpu_torch.data.loader import DataLoader
    from gan_codes_tpu_torch.models.clip import CLIP
    from gan_codes_tpu_torch.ops.kernels.fused_modconv import \
        fused_modconv3x3
    from gan_codes_tpu_torch.train.trainer import Trainer

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    if cfg["optim"]["beta1"] != 0.0:
        raise ValueError("the gradient check reads Adam's first moment as "
                         "the last gradient, which needs beta1 = 0")
    common.set_precision(cfg)
    pcfg = port_config(cfg)
    tree = write_tree(ctx)
    clip = CLIP(pcfg.text_encoder).to(dev)
    clip.load_state_dict(weights_galip.make(cfg, "clip", ctx.seed, dev))
    step_seed = workgen.torch_seed(ctx.seed, "train.step")
    trainer = Trainer(pcfg, clip, os.path.join(ctx.workdir, "ckpt"),
                      os.path.join(ctx.workdir, "images"), seed=step_seed,
                      device=dev)
    state = trainer.state
    g_sd = weights_galip.make(cfg, "generator", ctx.seed, dev)
    state.generator.load_state_dict(g_sd)
    state.g_ema.load_state_dict(g_sd)
    state.discriminator.load_state_dict(
        weights_galip.make(cfg, "discriminator", ctx.seed, dev))
    loader_seed = workgen.torch_seed(ctx.seed, "train.loader")
    batch = cfg["train"]["batch_size"]
    data = dataclasses.replace(pcfg.data, data_dir=tree)
    loader = DataLoader(CUBDataset(data, "train", augment=True), batch,
                        shuffle=True, drop_last=True, seed=loader_seed,
                        num_threads=int(mix["decode_threads"]),
                        prefetch=int(mix["prefetch"]))
    feed = Feed(loader)
    ctx.log(f"[setup] {time.time() - ctx.t_process:.2f} s: tree, weights "
            "and trainer ready")
    try:
        first = next(iter(feed.take(1)))
        with torch.no_grad():  # the first batch, the step's own noise
            ids = torch.from_numpy(np.asarray(first["captions"])).to(dev)
            sents = clip(ids).float()
            rng = torch.Generator(device=dev)
            rng.set_state(state.rng.get_state())
            noise = torch.randn((batch, cfg["generator"]["latent_dim"]),
                                generator=rng, device=dev)
            fake0 = state.generator(noise, sents).permute(0, 3, 1, 2)
            first_out = {"sents": sents.cpu(), "fake": fake0.cpu()}
            del fake0
        losses: Dict[str, List[float]] = {}
        for k in range(REF_STEPS):
            batches = [first] if k == 0 else feed.take(1)
            for name, v in trainer.train_epoch(batches).items():
                losses.setdefault(name, []).append(v)
            if k == 0:
                grad_norms = first_gradients(state)
                step1 = first_change(state, g_sd)
        del g_sd
        after = {"g": _host(state.generator), "d": _host(state.discriminator),
                 "ema": _host(state.g_ema)}
        tokens_a_step = trainer.clip_tokens
        common.sync(dev)
        if ctx.trace:
            warm_profiler()
        ctx.log(f"[setup] {time.time() - ctx.t_process:.2f} s: the first "
                f"{REF_STEPS} steps done; {tokens_a_step} CLIP tokens a step")

        wait0 = trainer.host_seconds["data_wait"]
        timer = trainer.timers["step"]
        timer.resolve()
        n_timed = len(timer.times)
        k2_0 = fused_modconv3x3.launches
        given0 = feed.given
        ctx.start_window()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        tracer = StepTracer(t0 + ctx.seconds / 3,
                            int(ctx.cell_file["trace_steps"])) \
            if ctx.trace else None
        means = trainer.train_epoch(feed.until(deadline, tracer))
        elapsed = time.perf_counter() - t0
        ctx.end_window()
        steps = feed.given - given0
        trace = tracer.finish() if tracer else None
        timer.resolve()
        step_times = timer.times[n_timed:]
        failed = steps if not all(np.isfinite(v) for v in means.values()) \
            else 0
        program = {"data_wait_s": trainer.host_seconds["data_wait"] - wait0
                   - (tracer.own_s if tracer else 0.0),
                   "step_s_mean": float(np.mean(step_times))
                   if step_times else float("nan"),
                   "steps": steps, "clip_tokens": tokens_a_step,
                   "k2_launches_per_step":
                       (fused_modconv3x3.launches - k2_0) / max(steps, 1)}
        peak = common.memory_peak(dev)
        ctx.log(f"[galip] window: {steps} steps in {elapsed:.3f} s, "
                f"{batch * steps / elapsed:.2f} img/s, device ms a step "
                f"{1e3 * program['step_s_mean']:.1f}, K2 launches a step "
                f"{program['k2_launches_per_step']:.2f}, memory peak "
                f"{peak / 2**30:.2f} GiB, losses {means}")
    finally:
        feed.close()
    del trainer, state, clip, loader, feed
    common.free(dev)

    want = reference(ctx, tree, step_seed, loader_seed)
    change = _norms({f"{m}.{n}": after[m][n] - want["p0"][f"{m}.{n}"]
                     for m in after for n in after[m]})
    change.update(step1)
    prog = {"losses": losses, "grads": grad_norms, "change": change,
            **first_out}
    out_checks = galip_checks(prog, want, ctx.log)
    return core.Window(
        e2e={"train_img_per_s": steps * batch / elapsed},
        attempted=steps, failed=failed, program=program, trace=trace,
        memory_peak_bytes=peak, checks=out_checks, seconds=elapsed)


def galip_checks(prog: dict, want: dict, log=None) -> Dict[str, float]:
    """The numbers of the GALIP cell: a run's (`prog`: its losses by
    step, first gradients, change norms after the steps, first sentences
    and images) against the reference's (`reference`)."""
    s, s_ref = prog["sents"].double(), want["sents"].double()
    f, f_ref = prog["fake"].double(), want["fake"].double()
    out = {"sent_gap": float((s - s_ref).abs().max() / s_ref.abs().max()),
           "img_gap": float((f - f_ref).abs().max()),
           "loss_gap": checks.loss_gap(
               {"d_loss": prog["losses"]["d_loss"][:1]},
               {"d_loss": want["losses"]["d_loss"][:1]}),
           "loss_gap_all": checks.loss_gap(
               {k: prog["losses"][k] for k in want["losses"]},
               want["losses"])}
    for m in ("d", "g"):
        keep = [n for n in want["grads"] if n.startswith(m + ".")]
        g = checks.leaf_gaps(prog["grads"], want["grads"], keep)
        out[f"grad_gap_{m}"] = max(g.values())
        out[f"grad_gap_{m}_median"] = statistics.median(g.values())
    for m in ("d", "g", "ema", "g1", "ema1"):
        keep = [n for n in want["change"] if n.startswith(m + ".")
                and n in want["moved"]]
        c = checks.leaf_gaps(prog["change"], want["change"], keep)
        pre = "change1_gap_" + m[:-1] if m.endswith("1") else \
            "change_gap_" + m
        out[pre] = statistics.median(c.values())
        out[pre + "_worst"] = max(c.values())
    # G's first change held by its worst leaf, as the DF-GAN cells hold it
    out["change1_gap_g"] = out.pop("change1_gap_g_worst")
    if log:
        for k, r in want["losses"].items():
            log(f"[galip] {k} by step {prog['losses'].get(k)} against {r}")
        log("[galip] readings " + json.dumps(out))
    return out


def reference(ctx: core.Context, tree: str, step_seed: int,
              loader_seed: int, precision=common.reference_precision,
              autocast=None, batch_fraction: float = 1.0) -> dict:
    """The plain reference over the first `REF_STEPS` steps from the same
    weights, batches and random stream: the first batch's sentences and
    G's images (the step's noise), each step's losses, the first
    gradients by leaf ("g.", "d."), each leaf's change after the last
    step, the weights before (host tensors), and the leaves whose gradient
    reaches a thousandth of the module's median leaf's (`moved`). The
    changes go by "g.", "d.", "ema." leaf after the last step and by
    "g1.", "ema1." after the first."""
    cfg, dev = ctx.cfg, ctx.device
    precision()
    batch = cfg["train"]["batch_size"]
    data = ref.CubClipReference(
        tree, cfg["generator"]["image_size"], batch, loader_seed,
        captions_per_image=int(ctx.mix["captions_per_image"]),
        max_len=cfg["data"]["max_caption_len"])
    p0 = {m: weights_galip.make(cfg, name, ctx.seed, dev) for m, name in
          (("g", "generator"), ("d", "discriminator"))}
    clip = weights_galip.make(cfg, "clip", ctx.seed, dev)
    st = ref.TrainState(cfg, p0["g"], p0["d"], clip,
                        torch.Generator(device=dev).manual_seed(step_seed))
    ct = cfg["text_encoder"]
    losses: Dict[str, List[float]] = {}
    out = {}
    for k in range(REF_STEPS):
        imgs, ids, _ = data.batch(0, k)
        x = (torch.from_numpy(imgs).to(dev).float() / 127.5 - 1.0).permute(
            0, 3, 1, 2)
        ids = torch.from_numpy(ids).to(dev)
        with autocast() if autocast else contextlib.nullcontext():
            if k == 0:
                with torch.no_grad():
                    s = ref.encode_text(clip, ids, ct["transformer_heads"])
                    rng = torch.Generator(device=dev)
                    rng.set_state(st.rng.get_state())
                    noise = torch.randn(
                        (batch, cfg["generator"]["latent_dim"]),
                        generator=rng, device=dev)
                    out["sents"] = s.float().cpu()
                    out["fake"] = ref.generator(p0["g"], clip, noise, s,
                                                cfg).float().cpu()
            step = ref.train_step(st, x, ids, batch_fraction)
        for name, v in step.items():
            losses.setdefault(name, []).append(v)
        if k == 0:
            first = {}
            for m, params, grads in (("g.", st.g, st.g_opt.first),
                                     ("d.", st.d, st.d_opt.first)):
                first.update({m + n: v for n, v in _norms(
                    dict(zip(params, grads))).items()})
            step1 = _norms({f"{m}1.{n}": now[n].detach() - p0["g"][n]
                            for m, now in (("g", st.g), ("ema", st.ema))
                            for n in now})
    moved = set()
    for m, opt, params in (("g.", st.g_opt, st.g), ("d.", st.d_opt, st.d)):
        top = torch.stack(opt.norms).max(dim=0).values.cpu().tolist()
        med = float(np.median(top))
        moved |= {m + n for n, v in zip(params, top) if v >= 1e-3 * med}
    moved |= {m + n[2:] for n in moved if n.startswith("g.")
              for m in ("ema.", "g1.", "ema1.")}
    change, before = {}, {}
    for m, now, was in (("g", st.g, p0["g"]), ("d", st.d, p0["d"]),
                        ("ema", st.ema, p0["g"])):
        for n in now:
            change[f"{m}.{n}"] = (now[n].detach() - was[n]).double().norm()
            before[f"{m}.{n}"] = was[n].cpu()
    change = {n: float(v) for n, v in zip(
        change, torch.stack(list(change.values())).cpu().tolist())}
    change.update(step1)
    return {"losses": losses, "grads": first, "change": change,
            "p0": before, "moved": moved, **out}


def tf32_precision() -> None:
    """One TF32 pass in cuBLAS and cuDNN, the program's precision, for
    the reference as a second witness."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def controls(ctx: core.Context) -> dict:
    """The readings of the reference in bfloat16 (autocast, TF32 off), on
    half the batch, with its EMA at decay 0.99 and at one TF32 pass,
    against the reference, on one seed's tree."""
    tree = write_tree(ctx)
    step_seed = workgen.torch_seed(ctx.seed, "train.step")
    loader_seed = workgen.torch_seed(ctx.seed, "train.loader")
    want = reference(ctx, tree, step_seed, loader_seed)

    def against(**kw):
        return galip_checks(reference(ctx, tree, step_seed, loader_seed,
                                      **kw), want)

    dev = ctx.device.split(":")[0]
    decay = dataclasses.replace(ctx, cfg=core.merge(
        ctx.cfg, {"train": {"ema_decay": 0.99}}))
    return {"control": against(autocast=lambda: torch.autocast(
                dev, dtype=torch.bfloat16)),
            "half_batch": against(batch_fraction=0.5),
            "ema_decay": galip_checks(reference(
                decay, tree, step_seed, loader_seed), want),
            "tf32": against(precision=tf32_precision)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GALIP's controls")
    ap.add_argument("--controls", action="store_true", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workload", default="galip-cub224-tf32-train")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are read on a CUDA card", file=sys.stderr)
        return 2
    spec = spec_mod.Spec()
    entry = spec.cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="h100_control_",
                                   dir=os.environ.get("TMPDIR"))
        try:
            ctx = core.Context(
                cell=a.workload, cfg=spec.config(entry["config"]),
                mix=spec.traffic(entry["traffic"]),
                cell_file=spec.cell_file(a.workload), seed=seed,
                seconds=0.0, trace=False, device="cuda", workdir=workdir,
                t_process=0.0)
            print(json.dumps({"workload": a.workload, "seed": seed,
                              **controls(ctx)}), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            common.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())

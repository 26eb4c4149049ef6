"""Training: `Trainer.train_epoch` over the port's `DataLoader` on a
CUB-layout tree written from the seed.

Set-up writes the tree, builds one `Trainer` with the seed's weights and
drives it through its first three steps, each a `train_epoch` call on the
same feed as the window's; those steps are the warm-up and what the
reference follows. The window hands `train_epoch` one iterable that
chains the loader's epochs until `--seconds` have passed; the rate is the
window's images over its wall time, from its first batch request to the
end of its last step. With `--trace 1` the profiler records
`trace_steps` steps a third of the way in, started and stopped as the
feed hands out batches (`StepTracer`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import checks, core, workgen, weights
from ..reference import dfgan
from ..reference.data import CubReference
from ..trace import Trace, profiler, warm_profiler
from . import common

REF_STEPS = 3


class Feed:
    """The loader's epochs, chained, epoch e after `set_epoch(e)`; counts
    the batches it hands out."""

    def __init__(self, loader):
        self.loader = loader
        self.given = 0
        self.times: List[float] = []  # when `until` handed each out
        self._it = self._chain()

    def _chain(self):
        for epoch in itertools.count():
            self.loader.set_epoch(epoch)
            for batch in self.loader:
                self.given += 1
                yield batch

    def take(self, n: int):
        return itertools.islice(self._it, n)

    def until(self, deadline: float, hook=None):
        """Batches until `deadline`; `hook()` runs before each is handed
        out."""
        while time.perf_counter() < deadline:
            if hook is not None:
                hook()
            batch = next(self._it)
            self.times.append(time.perf_counter())
            yield batch

    def close(self) -> None:
        self._it.close()


class StepTracer:
    """The profiler over `n` steps of a running `train_epoch`, from the
    first batch handed out after `at` (perf_counter seconds): started and
    stopped as the feed hands out batches, so the steps around them run
    as in any window (the stop waits for the device)."""

    def __init__(self, at: float, n: int):
        self.at, self.n = at, n
        self.prof, self.handed, self.stopped = None, 0, False
        self.own_s = 0.0  # its start and stop, inside the loader's wait

    def __call__(self) -> None:
        if self.stopped:
            return
        t = time.perf_counter()
        if self.prof is None:
            if t >= self.at:
                self.prof = profiler()
                self.prof.start()
        else:
            self.handed += 1
            if self.handed == self.n:
                self.prof.stop()
                self.stopped = True
        self.own_s += time.perf_counter() - t

    def finish(self) -> Optional[Trace]:
        """The trace of the steps between the start and the stop (stopped
        here if the window ended first), once the window has closed."""
        if self.prof is None:
            return None
        if not self.stopped:
            self.prof.stop()
        return Trace(self.prof, self.handed)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().double().norm()
                        for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def first_gradients(state) -> Dict[str, float]:
    """Norms of the gradients each optimizer got, by leaf, worked out from
    its state after one step (beta1 = 0, so Adam's first moment is the
    last gradient): G's (phase 3) as "g.", D's MA-GP gradient (phase 2,
    its last) as "d2.", and D's first (phase 1) as "d1.", from the second
    moment, v = b2 (1 - b2) g1^2 + (1 - b2) g2^2."""
    b2 = state.d_opt.adam.param_groups[0]["betas"][1]
    out = {}
    for (n, _), p in zip(state.generator.named_parameters(),
                         state.g_opt.params):
        st = state.g_opt.adam.state.get(p, {})
        out["g." + n] = st["exp_avg"] if st else torch.zeros_like(p)
    for (n, _), p in zip(state.discriminator.named_parameters(),
                         state.d_opt.params):
        st = state.d_opt.adam.state.get(p, {})
        m = st["exp_avg"] if st else torch.zeros_like(p)
        v = st["exp_avg_sq"] if st else torch.zeros_like(p)
        out["d2." + n] = m
        out["d1." + n] = ((v - (1 - b2) * m * m) / (b2 * (1 - b2))).clamp(
            min=0).sqrt()
    return _norms(out)


def first_change(state, g0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norms by leaf of G's and the EMA's change over the first step, as
    "g1." and "ema1." (G's weights before it: `g0`)."""
    return _norms({f"{m}1.{n}": p.detach() - g0[n]
                   for m, mod in (("g", state.generator), ("ema", state.g_ema))
                   for n, p in mod.named_parameters()})


def _host(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in module.named_parameters()}


def run(ctx: core.Context) -> core.Window:
    from gan_codes_tpu_torch.data.dataset import CUBDataset
    from gan_codes_tpu_torch.data.loader import DataLoader
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.train.trainer import Trainer

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    if cfg["optim"]["beta1"] != 0.0:
        raise ValueError("the gradient check reads Adam's first moment as "
                         "the last gradient, which needs beta1 = 0")
    common.set_precision(cfg)
    pcfg = common.port_config(cfg)
    tree = os.path.join(ctx.workdir, "cub")
    workgen.write_cub_tree(tree, ctx.seed, mix,
                           cfg["text_encoder"]["vocab_size"])
    te = RNNEncoder(pcfg.text_encoder).to(dev)
    te.load_state_dict(weights.make(cfg, "text_encoder", ctx.seed, dev))
    step_seed = workgen.torch_seed(ctx.seed, "train.step")
    trainer = Trainer(pcfg, te, os.path.join(ctx.workdir, "ckpt"),
                      os.path.join(ctx.workdir, "images"), seed=step_seed,
                      device=dev)
    state = trainer.state
    g_sd = weights.make(cfg, "generator", ctx.seed, dev)
    state.generator.load_state_dict(g_sd)
    state.g_ema.load_state_dict(g_sd)
    state.discriminator.load_state_dict(
        weights.make(cfg, "discriminator", ctx.seed, dev))
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
        # the first steps: the warm-up, and what the reference follows
        losses: Dict[str, List[float]] = {}
        for k in range(REF_STEPS):
            for name, v in trainer.train_epoch(feed.take(1)).items():
                losses.setdefault(name, []).append(v)
            if k == 0:
                grad_norms = first_gradients(state)
                step1 = first_change(state, g_sd)
        del g_sd
        after = {"g": _host(state.generator), "d": _host(state.discriminator),
                 "ema": _host(state.g_ema)}
        common.sync(dev)
        if ctx.trace:
            warm_profiler()
        ctx.log(f"[setup] {time.time() - ctx.t_process:.2f} s: the first "
                f"{REF_STEPS} steps done")

        # the window
        wait0 = trainer.host_seconds["data_wait"]
        timer = trainer.timers["step"]
        timer.resolve()
        n_timed = len(timer.times)
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
                   "steps": steps}
        peak = common.memory_peak(dev)
        ctx.log(f"[train] window: {steps} steps in {elapsed:.3f} s, loader "
                f"wait {program['data_wait_s']:.3f} s; img/s by third "
                + " / ".join(f"{batch * r:.2f}" for r in
                             core.thirds(feed.times, t0, elapsed))
                + "; device ms a step by third " + " / ".join(
                    f"{1e3 * np.mean(t):.1f}" for t in
                    np.array_split(np.asarray(step_times), 3) if len(t)))
    finally:
        feed.close()
    del trainer, state, te, loader, feed
    common.free(dev)

    ref = reference(ctx, tree, step_seed, loader_seed)
    change = _norms({f"{m}.{n}": after[m][n] - ref["p0"][f"{m}.{n}"]
                     for m in after for n in after[m]})
    change.update(step1)
    out_checks = train_checks(losses, grad_norms, change, ref, ctx.log)
    return core.Window(
        e2e={"train_img_per_s": steps * batch / elapsed},
        attempted=steps, failed=failed, program=program, trace=trace,
        memory_peak_bytes=peak, checks=out_checks, seconds=elapsed)


def train_checks(losses: Dict[str, List[float]], grads: Dict[str, float],
                 change: Dict[str, float], ref: dict, log=None
                 ) -> Dict[str, float]:
    """The numbers of a training cell against the reference's
    (`reference`), from a run's per-step losses, its first gradients
    (`first_gradients`: "g.", "d1.", "d2.") and its change norms after
    `REF_STEPS` steps (by "g.", "d.", "ema." leaf) and after the first
    (`first_change`: "g1.", "ema1."). The cell's file says which are
    held; the rest are logged:

    - `loss_gap`: the first step's D loss, the one loss computed before
      any update (`loss_gap_step1`: its three losses; `loss_gap_all`:
      every step's). A loss computed after an Adam update moves with the
      sign Adam gives each gradient element within rounding of zero (+-lr
      either way), so it differs between two sound runs by far more than
      their arithmetic does;
    - each optimizer's first gradient, by the worst leaf: `grad_gap_d`
      (D's, phase 1), `grad_gap_g` (G's, phase 3), `grad_gap_gp` (D's
      MA-GP, phase 2), and by the median leaf (`*_median`);
    - each module's change after the steps, by its median leaf, over the
      leaves the reference moves (`moved`): `change_gap_d` (D),
      `change_gap_g` (G) and `change_gap_ema` (the EMA); the worst leaf:
      `change_gap_worst`. From the second step on, Adam turns a gradient
      element within rounding of zero into +-lr with either sign, and G's
      gradient passes through the D that those signs moved, so G's and
      the EMA's change swing from seed to seed;
    - G's change over the first step, by the worst leaf: `change1_gap_g`
      (G updated, at its learning rate, by Adam with its bias correction:
      each element moves by lr g / (|g| + eps), whatever its sign);
    - the EMA's change over the first step, by its median leaf:
      `change1_gap_ema` (the EMA updated from the new G at its decay).
      That change is (1 - decay) lr, a few ulps of a weight near 0.5, so
      one ulp that rounds the other way in a one-element leaf (a block's
      gamma) reads some 4% of the median leaf's change
      (`change1_gap_ema_worst`)."""
    def gaps(prog, want, prefixes, only=None):
        per = {}
        for p in prefixes:
            per[p] = checks.leaf_gaps(prog, want, [
                n for n in want if n.startswith(p) and (only is None
                                                        or n in only)])
        return per

    g = gaps(grads, ref["grads"], ("g.", "d1.", "d2."))
    c = gaps(change, ref["change"], ("g.", "d.", "ema.", "g1.", "ema1."),
             ref["moved"])
    first = {k: v[:1] for k, v in ref["losses"].items()}
    out = {"loss_gap": checks.loss_gap({"d_loss": losses["d_loss"][:1]},
                                       {"d_loss": first["d_loss"]}),
           "loss_gap_step1": checks.loss_gap(
               {k: losses[k][:1] for k in first}, first),
           "loss_gap_all": checks.loss_gap(
               {k: losses[k] for k in ref["losses"]}, ref["losses"]),
           "change_gap_worst": max(max(c[p].values())
                                   for p in ("g.", "d.", "ema."))}
    for p in ("d", "g", "ema"):
        out["change_gap_" + p] = statistics.median(c[p + "."].values())
    out["change1_gap_g"] = max(c["g1."].values())
    out["change1_gap_ema"] = statistics.median(c["ema1."].values())
    out["change1_gap_ema_worst"] = max(c["ema1."].values())
    for p, name in (("d1.", "grad_gap_d"), ("g.", "grad_gap_g"),
                    ("d2.", "grad_gap_gp")):
        out[name] = max(g[p].values())
        out[name + "_median"] = statistics.median(g[p].values())
    if log:
        for k, r in ref["losses"].items():
            log(f"[train] {k} by step {losses[k]} against {r}")
        for name, per in (("grad", g), ("change", c)):
            for p, v in per.items():
                n, worst = max(v.items(), key=lambda kv: kv[1])
                log(f"[train] {name} {p} median leaf gap "
                    f"{statistics.median(v.values()):.4g}, worst {worst:.4g}"
                    f" ({n})")
        log("[train] readings " + json.dumps(out))
    return out


def reference(ctx: core.Context, tree: str, step_seed: int, loader_seed: int,
              precision=common.reference_precision, autocast=None,
              batch_fraction: float = 1.0) -> dict:
    """The plain reference over the first `REF_STEPS` steps from the same
    weights, batches and random stream: each step's losses, the first
    step's clipped gradients (`first_gradients`' names), each leaf's
    change after the last step (by "g.", "d.", "ema." name) and after the
    first (`first_change`' names), the weights before (host tensors), and
    the leaves whose gradient reaches a
    thousandth of the module's median leaf's (`moved`)."""
    cfg, dev = ctx.cfg, ctx.device
    precision()
    batch = cfg["train"]["batch_size"]
    data = CubReference(tree, cfg["generator"]["image_size"], batch,
                        loader_seed,
                        captions_per_image=int(ctx.mix["captions_per_image"]),
                        max_len=cfg["text_encoder"]["max_len"])
    p0 = {m: weights.make(cfg, name, ctx.seed, dev) for m, name in
          (("g", "generator"), ("d", "discriminator"))}
    st = dfgan.TrainState(cfg, p0["g"], p0["d"],
                          weights.make(cfg, "text_encoder", ctx.seed, dev),
                          torch.Generator(device=dev).manual_seed(step_seed))
    losses: Dict[str, List[float]] = {}
    first, step1 = {}, {}
    for k in range(REF_STEPS):
        imgs, caps, lens = data.batch(0, k)
        x = torch.from_numpy(imgs).to(dev).float() / 127.5 - 1.0
        with autocast() if autocast else contextlib.nullcontext():
            out = dfgan.train_step(st, x.permute(0, 3, 1, 2),
                                   torch.from_numpy(caps).to(dev),
                                   torch.from_numpy(lens), batch_fraction)
        for name, v in out.items():
            losses.setdefault(name, []).append(v)
        if k == 0:  # G's phase-3 gradient, D's phase 1 and 2, clipped
            for m, params, grads in (("g.", st.g, st.g_opt.first),
                                     ("d1.", st.d, st.d_opt.first),
                                     ("d2.", st.d, st.d_opt.last)):
                first.update({m + n: v for n, v in _norms(
                    dict(zip(params, grads))).items()})
            step1 = _norms({f"{m}1.{n}": now[n].detach() - p0["g"][n]
                            for m, now in (("g", st.g), ("ema", st.ema))
                            for n in now})
    grad_max = {}
    for m, opt, params in (("g.", st.g_opt, st.g), ("d.", st.d_opt, st.d)):
        top = torch.stack(opt.norms).max(dim=0).values.cpu().tolist()
        grad_max.update({m + n: v for n, v in zip(params, top)})
    moved = set()
    for m in ("g.", "d."):
        names = [n for n in grad_max if n.startswith(m)]
        med = float(np.median([grad_max[n] for n in names]))
        moved |= {n for n in names if grad_max[n] >= 1e-3 * med}
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
            "p0": before, "moved": moved}

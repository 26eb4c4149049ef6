"""The controls and planted faults that the cells' limits are set
between, read at a cell's own size.

    python3 h100_bench/control.py --workload <cell> --seeds 11,12,13

For each seed it prints one JSON line of readings: the numbers the cell
compares, each with the plain reference put in the program's place,
computed one precision below the configuration's (`control`: TF32 for
fp32 with TF32 off, bfloat16 for TF32), and for training cells with the
faults planted in the reference put in the program's place: half the
batch left out, the mean taken over the rest (`half_batch`), the EMA at
decay 0.99 (`ema_decay`) and G stepped at D's learning rate (`g_lr`). A
step that leaves its state, G or the EMA unchanged reads 1 by the
measure (no run). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from h100_bench import checks, core, spec as spec_mod, workgen  # noqa: E402
from h100_bench.drivers import common, generate, serve, train  # noqa: E402


def tf32_on() -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def bf16(device: str):
    return lambda: torch.autocast(device.split(":")[0], dtype=torch.bfloat16)


def lower(cfg: dict, device: str):
    """(precision, autocast) of the control: one step below the
    configuration's precision."""
    if cfg["precision"] == "float32":
        return tf32_on, None
    return common.reference_precision, bf16(device)


def readings(ctx: core.Context) -> dict:
    precision, autocast = lower(ctx.cfg, ctx.device)
    driver = ctx.mix["driver"]
    if driver == "train":
        tree = os.path.join(ctx.workdir, "cub")
        workgen.write_cub_tree(tree, ctx.seed, ctx.mix,
                               ctx.cfg["text_encoder"]["vocab_size"])
        step_seed = workgen.torch_seed(ctx.seed, "train.step")
        loader_seed = workgen.torch_seed(ctx.seed, "train.loader")
        ref = train.reference(ctx, tree, step_seed, loader_seed)

        def against(cfg=None, **kw):
            fault = dataclasses.replace(ctx, cfg=core.merge(ctx.cfg, cfg))
            out = train.reference(fault, tree, step_seed, loader_seed, **kw)
            return train.train_checks(out["losses"], out["grads"],
                                      out["change"], ref)

        return {"control": against(precision=precision, autocast=autocast),
                "half_batch": against(batch_fraction=0.5),
                "ema_decay": against({"train": {"ema_decay": 0.99}}),
                "g_lr": against({"optim": {"g_lr": ctx.cfg["optim"]["d_lr"]}})}
    if driver == "generate":
        batch = int(ctx.mix["batch"])
        t = ctx.cfg["text_encoder"]
        g = workgen.rng(ctx.seed, "generate.captions")
        items = [(k + 1,) + workgen.token_batch(
            g, batch, t["vocab_size"], t["max_len"],
            ctx.mix["caption_words"])
            for k in range(int(ctx.cell_file["sample_calls"]))]
        seed = workgen.torch_seed(ctx.seed, "generate.noise")
        ref = generate.images(ctx, seed, items)
        ctl = generate.images(ctx, seed, items, precision, autocast)
        return {"control": generate.image_checks(ctl, ref)}
    if driver == "serve":
        batch = int(ctx.mix["batch_size"])
        t = ctx.cfg["text_encoder"]
        n = int(ctx.cell_file["sample_requests"])
        toks, _ = workgen.token_batch(workgen.rng(ctx.seed, "serve.prompts"),
                                      n, t["vocab_size"], t["max_len"],
                                      ctx.mix["caption_words"])
        rows = [(row, (i // batch, i % batch)) for i, row in enumerate(toks)]
        seed = workgen.torch_seed(ctx.seed, "serve.noise")
        ref = serve.images(ctx, seed, batch, rows)
        ctl = serve.images(ctx, seed, batch, rows, precision, autocast)
        return {"control": checks.pixel_gaps(ctl, ref)}
    raise ValueError(f"no control for driver {driver!r}")


def run(cell: str, seeds, device: str = "cuda", spec=None, size=None):
    """Yields (seed, readings) for each seed."""
    spec = spec or spec_mod.Spec()
    size = size or {}
    entry = spec.cell(cell)
    cfg = core.merge(spec.config(entry["config"]), size.get("cfg"))
    mix = core.merge(spec.traffic(entry["traffic"]), size.get("mix"))
    cell_file = core.merge(spec.cell_file(cell), size.get("cell_file"))
    for seed in seeds:
        workdir = tempfile.mkdtemp(prefix="h100_control_",
                                   dir=os.environ.get("TMPDIR"))
        try:
            ctx = core.Context(cell=cell, cfg=cfg, mix=mix,
                               cell_file=cell_file, seed=seed, seconds=0.0,
                               trace=False, device=device, workdir=workdir,
                               t_process=0.0)
            yield seed, readings(ctx)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            common.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are read on a CUDA card", file=sys.stderr)
        return 2
    for seed, r in run(a.workload, [int(s) for s in a.seeds.split(",")]):
        print(json.dumps({"workload": a.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

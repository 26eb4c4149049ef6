"""Data-parallel training over the cards of one host: `train_entry --dp`'s
path (`parallel/`, `train/step.py` with a mesh), one rank process a card,
each `Trainer.train_epoch` over its rows of every global batch
(`DataLoader` with `parallel.dp.loader_shard`), NCCL between them.

`run` writes the CUB tree, builds the kernels once, then starts
`ranks` processes (spawned; the group's address on localhost, a free
port), each as `torchrun` would describe it. Every rank loads the seed's
weights, runs the first three steps (the warm-up, and what the reference
follows), and the window: rank 0 decides on its own clock, before each
batch, whether the window goes on, and tells the others over a CPU (gloo)
group, so every rank takes the same steps without a device sync. The rate
is the global images over rank 0's window, from its first batch request
to the end of its last step. With `--trace 1` the profiler records
`trace_steps` steps on rank 0 (`StepTracer`), whose spans come back in
`program["spans"]` (the program's span registry lives in the rank).

`correct`: rank 0's first steps against the plain reference at the global
batch, by `drivers/train.py`'s numbers and the limits of its cell, and
`rank_gap`, the widest difference of any parameter (G, D, the EMA)
between a rank and rank 0 after the window: the ranks step in lockstep
bit for bit.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import socket
import time
from typing import Dict, List

import numpy as np
import torch

from .. import core, weights, workgen
from ..trace import warm_profiler
from . import common
from .train import (REF_STEPS, Feed, StepTracer, _host, _norms,
                    first_change, first_gradients, reference, train_checks)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx: core.Context) -> core.Window:
    import multiprocessing

    cfg, mix = ctx.cfg, ctx.mix
    world = int(mix["ranks"])
    if cfg["optim"]["beta1"] != 0.0:
        raise ValueError("the gradient check reads Adam's first moment as "
                         "the last gradient, which needs beta1 = 0")
    tree = os.path.join(ctx.workdir, "cub")
    workgen.write_cub_tree(tree, ctx.seed, mix,
                           cfg["text_encoder"]["vocab_size"])
    if ctx.device.startswith("cuda"):
        from gan_codes_tpu_torch.ops.kernels import _build

        _build.build()  # once, before the ranks load it
    job = {"cfg": cfg, "mix": mix, "cell_file": ctx.cell_file,
           "seed": ctx.seed, "seconds": ctx.seconds, "trace": ctx.trace,
           "device": ctx.device.split(":")[0], "workdir": ctx.workdir,
           "tree": tree, "world": world, "port": _free_port()}
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_rank, args=(r, job)) for r in range(world)]
    for p in procs:
        p.start()
    limit = time.time() + ctx.seconds + 900
    while any(p.is_alive() for p in procs):
        if time.time() > limit or any(p.exitcode not in (None, 0)
                                      for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    out = torch.load(os.path.join(ctx.workdir, "rank0.pt"),
                     weights_only=False)
    ctx.window_at = out["window_at"]
    for line in out["log"]:
        ctx.log(line)

    # the reference at the global batch, on the first card
    ref_ctx = dataclasses.replace(ctx, cfg=core.merge(
        cfg, {"train": {"batch_size": out["global_batch"]}}),
        device="cuda:0" if ctx.device.startswith("cuda") else ctx.device)
    step_seed = workgen.torch_seed(ctx.seed, "train.step")
    loader_seed = workgen.torch_seed(ctx.seed, "train.loader")
    ref = reference(ref_ctx, tree, step_seed, loader_seed)
    after = out["after"]
    change = _norms({f"{m}.{n}": after[m][n] - ref["p0"][f"{m}.{n}"]
                     for m in after for n in after[m]})
    change.update(out["step1"])
    checks = train_checks(out["losses"], out["grads"], change, ref, ctx.log)
    checks["rank_gap"] = out["rank_gap"]
    return core.Window(
        e2e={"train_img_per_s": out["steps"] * out["global_batch"]
             / out["elapsed"]},
        attempted=out["steps"], failed=out["failed"], program=out["program"],
        trace=out["trace"], memory_peak_bytes=out["peak"], checks=checks,
        seconds=out["elapsed"])


def _agreed(feed: Feed, deadline: float, rank: int, group, hook=None):
    """The feed's batches while rank 0's clock is before `deadline`, the
    same count on every rank (rank 0's verdict over the CPU group)."""
    import torch.distributed as dist

    flag = torch.zeros(1, dtype=torch.int32)
    while True:
        if rank == 0:
            flag[0] = int(time.perf_counter() < deadline)
        dist.broadcast(flag, 0, group=group)
        if not flag[0]:
            return
        if hook is not None:
            hook()
        batch = next(feed._it)
        feed.times.append(time.perf_counter())
        yield batch


def _rank_gap(mesh, modules) -> float:
    """The widest difference of any parameter from rank 0's, over the
    ranks."""
    import torch.distributed as dist

    worst = torch.zeros((), device=mesh.device)
    for module in modules:
        for p in module.parameters():
            ref = p.detach().clone()
            dist.broadcast(ref, 0)
            worst = torch.maximum(worst, (p.detach() - ref).abs().max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _rank(rank: int, job: dict) -> None:
    """One rank: the trainer on its card, the warm-up, the window; rank 0
    saves what `run` reads to `rank0.pt`."""
    import torch.distributed as dist

    world = job["world"]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(job["port"]),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      GROUP_RANK="0")
    from gan_codes_tpu_torch.data.dataset import CUBDataset
    from gan_codes_tpu_torch.data.loader import DataLoader
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.parallel.dp import loader_shard
    from gan_codes_tpu_torch.parallel.mesh import close_mesh, init_mesh
    from gan_codes_tpu_torch.train.trainer import Trainer

    cfg, mix, seed = job["cfg"], job["mix"], job["seed"]
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    mesh = init_mesh(job["device"])
    control = dist.new_group(backend="gloo")
    dev = mesh.device
    log: List[str] = []
    try:
        common.set_precision(cfg)
        global_batch = cfg["train"]["batch_size"] * world
        gcfg = core.merge(cfg, {"train": {"batch_size": global_batch}})
        pcfg = common.port_config(gcfg)
        te = RNNEncoder(pcfg.text_encoder).to(dev)
        te.load_state_dict(weights.make(cfg, "text_encoder", seed, dev))
        step_seed = workgen.torch_seed(seed, "train.step")
        wd = os.path.join(job["workdir"], f"rank{rank}")
        trainer = Trainer(pcfg, te, os.path.join(wd, "ckpt"),
                          os.path.join(wd, "images"), seed=step_seed,
                          device=dev, mesh=mesh)
        state = trainer.state
        g_sd = weights.make(cfg, "generator", seed, dev)
        state.generator.load_state_dict(g_sd)
        state.g_ema.load_state_dict(g_sd)
        state.discriminator.load_state_dict(
            weights.make(cfg, "discriminator", seed, dev))
        data = dataclasses.replace(pcfg.data, data_dir=job["tree"])
        loader = DataLoader(CUBDataset(data, "train", augment=True),
                            global_batch, shuffle=True, drop_last=True,
                            seed=workgen.torch_seed(seed, "train.loader"),
                            num_threads=int(mix["decode_threads"]),
                            prefetch=int(mix["prefetch"]),
                            **loader_shard(mesh))
        feed = Feed(loader)
        losses: Dict[str, List[float]] = {}
        for k in range(REF_STEPS):
            for name, v in trainer.train_epoch(feed.take(1)).items():
                losses.setdefault(name, []).append(v)
            if k == 0:
                grads = first_gradients(state)
                step1 = first_change(state, g_sd)
        after = {"g": _host(state.generator), "d": _host(state.discriminator),
                 "ema": _host(state.g_ema)}
        common.sync(str(dev))
        if job["trace"] and rank == 0:
            warm_profiler()
        dist.barrier()

        from gan_codes_tpu_torch.utils import profiling

        wait0 = trainer.host_seconds["data_wait"]
        timer = trainer.timers["step"]
        timer.resolve()
        n_timed = len(timer.times)
        given0 = feed.given
        window_at = time.time()
        t0 = time.perf_counter()
        tracer = StepTracer(t0 + job["seconds"] / 3,
                            int(job["cell_file"]["trace_steps"])) \
            if job["trace"] and rank == 0 else None
        means = trainer.train_epoch(_agreed(feed, t0 + job["seconds"], rank,
                                            control, tracer))
        elapsed = time.perf_counter() - t0
        steps = feed.given - given0
        trace = tracer.finish() if tracer else None
        timer.resolve()
        step_times = timer.times[n_timed:]
        rank_gap = _rank_gap(mesh, (state.generator, state.discriminator,
                                    state.g_ema))
        if rank == 0:
            program = {"data_wait_s": trainer.host_seconds["data_wait"]
                       - wait0 - (tracer.own_s if tracer else 0.0),
                       "step_s_mean": float(np.mean(step_times))
                       if step_times else float("nan"),
                       "steps": steps}
            if trace is not None:
                program["spans"] = copy.deepcopy(profiling.span_summary())
            log.append(f"[train_dp] window: {world} ranks, {steps} steps of "
                       f"{global_batch} in {elapsed:.3f} s, device ms a step"
                       f" {1e3 * program['step_s_mean']:.1f}, rank gap "
                       f"{rank_gap!r}")
            torch.save({"losses": losses, "grads": grads, "step1": step1,
                        "after": after, "window_at": window_at,
                        "elapsed": elapsed, "steps": steps,
                        "global_batch": global_batch,
                        "failed": steps if not all(
                            np.isfinite(v) for v in means.values()) else 0,
                        "program": program, "trace": trace,
                        "peak": torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else 0,
                        "rank_gap": rank_gap, "log": log},
                       os.path.join(job["workdir"], "rank0.pt"))
        feed.close()
        dist.barrier()
    finally:
        close_mesh(mesh)

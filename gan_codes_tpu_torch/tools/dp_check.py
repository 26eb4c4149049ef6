#!/usr/bin/env python3
"""The data-parallel train step held against the single-process step on
the global batch: two ranks, each a process of its own, step from one
state on their rows of each global batch, while this process steps the
same state on the whole batch; then the moment-reduced IS/FID of the
ranks' eval shards against `compute_is_fid` on their union.

    python3 -m gan_codes_tpu_torch.tools.dp_check --device cuda:0 \\
        --image-size 256 --local-batch 12 --inception inception_v3.pth

The ranks talk over gloo: on one card they share it (NCCL refuses two
ranks on one device), with `--device cpu` they run on the CPU. It starts
the ranks with a torchrun environment (a free localhost port), waits for
them at most `--timeout` seconds, and exits non-zero when a check fails:

* the ranks' whole states (G, D, EMA, both Adam states, step, RNG) equal
  bit for bit after every step;
* d_loss within rtol 1e-4 of the single-process step's, and rank 0's
  reduced phase-1 D gradients and phase-3 G gradients within 1e-3 of
  max|ref| of its (d_gp_loss and g_loss are printed: they come after D's
  Adam updates, and Adam's first update turns a D gradient within rounding
  of zero into +-lr, PERF.md);
* with `--inception`: IS - 1 within 1e-2 and FID within 1e-5, relative,
  of the direct scores over the union of the shards.

The CPU tests (tests/test_torch_port_dp*.py) call `make_case`,
`run_ranks` and `reference` with cases of their own and hold their own
tolerances; `chip_smoke.py` runs this script on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

D_LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3          # of max|ref|, over each gradient set
IS_RTOL = 1e-2           # IS - 1, relative
FID_RTOL = 1e-5


def make_case(image_size: int = 32, n_channels: int = 8,
              global_batch: int = 4, steps: int = 4, gp_interval: int = 1,
              seed: int = 1234, vocab_size: int = 40,
              nan_rank: Optional[int] = None, world: int = 2) -> dict:
    """A seeded case: the config, G, D and text-encoder weights (every
    block gamma away from 0), and `steps` global batches of images in
    [-1, 1], captions and lengths. `nan_rank`: one NaN pixel in that
    rank's rows of every batch. Noise is drawn from the state's generator
    (`"noises": None`)."""
    from ..config import GANConfig
    from ..models.text_encoder import RNNEncoder
    from ..train.state import create_train_state

    cfg = GANConfig.for_image_size(
        image_size, n_channels=n_channels, vocab_size=vocab_size,
        loss_overrides={"gp_interval": gp_interval},
        batch_size=global_batch)
    state = create_train_state(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (state.generator, state.discriminator):
            for name, p in module.named_parameters():
                if name.endswith(".gamma"):
                    p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        te = RNNEncoder(cfg.text_encoder)
    rng = np.random.default_rng(seed)
    t = cfg.text_encoder.max_len
    batches = []
    for _ in range(steps):
        images = rng.uniform(-1, 1, (global_batch, image_size, image_size,
                                     3)).astype(np.float32)
        if nan_rank is not None:
            b = global_batch // world
            images[nan_rank * b, 1, 2, 0] = np.nan
        batches.append((torch.from_numpy(images),
                        torch.from_numpy(rng.integers(
                            1, vocab_size, (global_batch, t))),
                        torch.from_numpy(rng.integers(
                            2, t + 1, (global_batch,)))))
    return {"cfg": dataclasses.asdict(cfg), "seed": seed,
            "g": state.generator.state_dict(),
            "d": state.discriminator.state_dict(),
            "te": te.state_dict(), "batches": batches, "noises": None,
            "eval": None}


def _build(case: dict, device: torch.device):
    """The case's train state (EMA = G) and frozen text encoder."""
    from ..config import GANConfig
    from ..models.text_encoder import RNNEncoder
    from ..train.state import create_train_state

    cfg = GANConfig.from_dict(case["cfg"])
    state = create_train_state(cfg, case["seed"], device=device)
    state.generator.load_state_dict(case["g"])
    state.g_ema.load_state_dict(case["g"])
    state.discriminator.load_state_dict(case["d"])
    te = RNNEncoder(cfg.text_encoder)
    te.load_state_dict(case["te"])
    te = te.to(device).eval().requires_grad_(False)
    return cfg, state, te


def digest(state, text_encoder=None) -> str:
    """sha256 over every tensor of the state, the step and the RNG."""
    from ..parallel.dp import state_tensors

    h = hashlib.sha256(str(state.step).encode())
    for t in state_tensors(state, text_encoder) + [state.rng.get_state()]:
        h.update(t.detach().reshape(-1).cpu().contiguous()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _recorder(state) -> Dict[str, list]:
    """Wrap both optimizers' `step` to keep a copy of the gradients each
    update receives (before the clip): `"d"` the D updates in order
    (phase 1, then phase 2 when it runs), `"g"` phase 3's."""
    seen: Dict[str, list] = {"d": [], "g": []}
    for key, opt in (("d", state.d_opt), ("g", state.g_opt)):
        def step(grads, _orig=opt.step, _key=key):
            grads = list(grads)
            seen[_key].append([g.detach().cpu().clone() for g in grads])
            return _orig(grads)
        opt.step = step
    return seen


def _run_steps(case: dict, cfg, state, te, step, rows: slice,
               device: torch.device, keep: bool) -> dict:
    """Step through the case's batches (`rows` of each); per step the
    metrics, the state's digest and, with `keep`, G's and D's parameters
    and the phase-1 D and phase-3 G gradients (on the host)."""
    seen = _recorder(state)
    out: dict = {"metrics": [], "digests": [], "params": [], "grads": []}
    for i, (images, captions, cap_lens) in enumerate(case["batches"]):
        noise = None
        if case["noises"] is not None:
            noise = case["noises"][i][rows].to(device)
        seen["d"].clear()
        seen["g"].clear()
        m = step(state, te, images[rows].to(device),
                 captions[rows].to(device), cap_lens[rows], noise=noise)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["digests"].append(digest(state, te))
        if keep:
            out["params"].append({
                "g": {k: v.detach().cpu().clone()
                      for k, v in state.generator.state_dict().items()},
                "d": {k: v.detach().cpu().clone()
                      for k, v in state.discriminator.state_dict().items()}})
            out["grads"].append({"d1": seen["d"][0], "g3": seen["g"][0]})
    return out


def _eval_rows(split: Sequence[int], rank: int) -> slice:
    start = int(sum(split[:rank]))
    return slice(start, start + int(split[rank]))


def _worker(case_path: str, out_path: str, device: str) -> None:
    """One rank (over gloo): replicate rank 0's state, step, then score
    its shard."""
    from ..models.inception import inception_to, load_torch_inception
    from ..eval.metrics import compute_is_fid_multihost
    from ..parallel.dp import replicate, shard_rows
    from ..parallel.mesh import close_mesh, init_mesh
    from ..train.step import make_train_step

    mesh = init_mesh(device, backend="gloo")
    try:
        case = torch.load(case_path, weights_only=True)
        cfg, state, te = _build(case, mesh.device)
        replicate(mesh, state, te)
        rows = shard_rows(mesh, case["batches"][0][0].shape[0]) \
            if case["batches"] else None
        t0 = time.perf_counter()
        out = _run_steps(case, cfg, state, te,
                         make_train_step(cfg, mesh), rows,
                         mesh.device, keep=mesh.primary)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out["step_seconds"] = time.perf_counter() - t0
        ev = case["eval"]
        if ev is not None:
            inc = inception_to(load_torch_inception(ev["inception"]),
                               mesh.device)
            r = _eval_rows(ev["split"], mesh.rank)
            out["eval"] = compute_is_fid_multihost(
                mesh, inc, ev["fakes"][r].to(mesh.device),
                ev["reals"][r].to(mesh.device))
        out["rank"] = mesh.rank
        torch.save(out, out_path)
    finally:
        close_mesh(mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case_path: str, out_dir: str, world: int = 2,
              device: str = "cpu", timeout: float = 120.0,
              threads: int = 2) -> List[dict]:
    """Run the case on `world` rank processes (one node) with a torchrun
    environment; returns each rank's results, in rank order. Raises with
    the ranks' output when one fails or the run outlasts `timeout`."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   GROUP_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=root)
        cmd = [sys.executable, "-m", "gan_codes_tpu_torch.tools.dp_check",
               "--worker", case_path,
               os.path.join(out_dir, f"rank{rank}.pt"), "--device", device]
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    for rank, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} failed (rc {p.returncode}):\n"
                               f"{text[-6000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=True) for r in range(world)]


def reference(case: dict, device: str | torch.device = "cpu") -> dict:
    """The single-process step on the case's global batches, from the
    same state, and the direct IS/FID over the eval shards' union."""
    from ..eval.metrics import compute_is_fid
    from ..models.inception import inception_to, load_torch_inception
    from ..train.step import make_train_step

    dev = torch.device(device)
    cfg, state, te = _build(case, dev)
    out = _run_steps(case, cfg, state, te, make_train_step(cfg),
                     slice(None), dev, keep=True)
    ev = case["eval"]
    if ev is not None:
        inc = inception_to(load_torch_inception(ev["inception"]), dev)
        out["eval"] = compute_is_fid(inc, ev["fakes"].to(dev),
                                     ev["reals"].to(dev))
    return out


def grad_gap(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """max|got - want| / max|want| over a gradient set."""
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want)) / scale


def _fakes(case: dict, n: int, device: torch.device, seed: int):
    """n fakes of the case's initial G (float32) on seeded noise and
    captions, and n seeded reals, for the eval check."""
    cfg, state, te = _build(case, device)
    gen = torch.Generator().manual_seed(seed)
    t = cfg.text_encoder.max_len
    caps = torch.randint(1, cfg.text_encoder.vocab_size, (n, t),
                         generator=gen)
    lens = torch.randint(2, t + 1, (n,), generator=gen)
    noise = torch.randn((n, cfg.generator.latent_dim), generator=gen)
    s = cfg.generator.image_size
    reals = torch.rand((n, s, s, 3), generator=gen) * 2 - 1
    with torch.no_grad():
        sents = te(caps.to(device), lens).float()
        fakes = torch.cat([state.generator(noise[i:i + 8].to(device),
                                           sents[i:i + 8]).float().cpu()
                           for i in range(0, n, 8)])
    return fakes, reals


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worker", nargs=2, metavar=("CASE", "OUT"),
                   help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--n-channels", type=int, default=32)
    p.add_argument("--local-batch", type=int, default=12)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--inception", default=None,
                   help="torchvision InceptionV3 state_dict for the eval "
                        "check (2 x --eval-per-rank fakes)")
    p.add_argument("--eval-per-rank", type=int, default=24)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--seed", type=int, default=1234)
    a = p.parse_args(argv)
    if a.worker:
        _worker(*a.worker, a.device)
        return 0

    from ..utils.device import serving_device

    dev = serving_device(a.device)
    world = 2
    case = make_case(a.image_size, a.n_channels, world * a.local_batch,
                     a.steps, 1, a.seed,
                     vocab_size=5450)
    if a.inception:
        n = world * a.eval_per_rank
        fakes, reals = _fakes(case, n, dev, a.seed + 1)
        case["eval"] = {"fakes": fakes, "reals": reals,
                        "split": [a.eval_per_rank] * world,
                        "inception": os.path.abspath(a.inception)}
    with tempfile.TemporaryDirectory(prefix="dp_check_") as tmp:
        path = os.path.join(tmp, "case.pt")
        torch.save(case, path)
        t0 = time.perf_counter()
        ranks = run_ranks(path, tmp, world, a.device, a.timeout)
        rank_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = reference(case, dev)
        ref_s = time.perf_counter() - t0
    failures = []
    report = {"world": world, "local_batch": a.local_batch,
              "image_size": a.image_size, "device": str(dev),
              "ranks_wall_s": rank_s,
              "rank_step_s": [r["step_seconds"] for r in ranks],
              "reference_wall_s": ref_s, "steps": []}
    for i in range(a.steps):
        same = len({r["digests"][i] for r in ranks}) == 1
        got, want = ranks[0]["metrics"][i], ref["metrics"][i]
        d_gap = abs(got["d_loss"] - want["d_loss"]) / abs(want["d_loss"])
        g1 = grad_gap(ranks[0]["grads"][i]["d1"], ref["grads"][i]["d1"])
        g3 = grad_gap(ranks[0]["grads"][i]["g3"], ref["grads"][i]["g3"])
        report["steps"].append({
            "ranks_bit_equal": same, "d_loss": [got["d_loss"],
                                                want["d_loss"]],
            "d_gp_loss": [got["d_gp_loss"], want["d_gp_loss"]],
            "g_loss": [got["g_loss"], want["g_loss"]],
            "d_loss_rel_gap": d_gap, "phase1_d_grad_gap": g1,
            "phase3_g_grad_gap": g3})
        if not same:
            failures.append(f"step {i}: the ranks' states differ")
        if not d_gap <= D_LOSS_RTOL:
            failures.append(f"step {i}: d_loss {got['d_loss']} vs "
                            f"{want['d_loss']}")
        if not (g1 <= GRAD_TOL and g3 <= GRAD_TOL):
            failures.append(f"step {i}: gradient gaps {g1} {g3}")
    if a.inception:
        (is_mh, fid_mh), (is_1, fid_1) = ranks[0]["eval"], ref["eval"]
        is_gap = abs(is_mh - is_1) / (is_1 - 1.0)
        fid_gap = abs(fid_mh - fid_1) / fid_1
        report["eval"] = {"multihost": [is_mh, fid_mh],
                          "other_rank": list(ranks[1]["eval"]),
                          "direct": [is_1, fid_1], "is_rel_gap": is_gap,
                          "fid_rel_gap": fid_gap}
        if list(ranks[1]["eval"]) != [is_mh, fid_mh]:
            failures.append("the ranks' IS/FID differ")
        if not (is_gap <= IS_RTOL and fid_gap <= FID_RTOL):
            failures.append(f"IS/FID {is_mh} {fid_mh} vs {is_1} {fid_1}")
    report["failures"] = failures
    print(json.dumps(report), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

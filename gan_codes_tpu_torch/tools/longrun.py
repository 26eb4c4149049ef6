"""Long training run with a mid-run SIGKILL and a resume (the port's
counterpart of `tools/longrun.py`).

Runs the port's `train_entry` in child processes at the reference
operating point (256px, batch 24, `src/train.py:20-22`) on a synthetic
CUB fixture: a straight leg of `--epochs` epochs, and a leg SIGKILLed
when it prints `Epoch k:` (k = `--kill-after-epoch`; the trainer prints it
once epoch k is checkpointed), then started again on the same directories,
where it must print "Resuming from epoch ...". The resumed run must equal
its uninterrupted twin bit for bit: the final G, D, EMA, both Adam states,
the step and the RNG state of the `checkpoint` file, and the histories.
It holds because the checkpoint carries the step's RNG, and the loader's
order and augmentation and the eval noise are keyed by the epoch.

It also checks the loss health of the straight leg over every epoch (the
JAX tool's bands): every value finite, the epoch-mean D hinge loss in
(0, 4), |G loss| < 20 (a runaway is the mode-collapse signature), the
MA-GP loss >= 0.

On CUDA every leg runs `--deterministic` (cuDNN's default conv gradients
add in an order that varies from run to run, so the twins would drift
apart). Each leg has its own time limit (`--leg-timeout` seconds).

    python -m gan_codes_tpu_torch.tools.longrun [--epochs 30] \\
        [--kill-after-epoch 14] [--batch-size 24] [--device cpu]

Artifacts (the straight leg's metrics, loss curves where matplotlib is
installed, sample grids of the first, quartile and last epochs, and
LONGRUN.json with the equivalence and health report) go to `--out`
(default `longrun_out/`), and the fixture and the legs' directories to
`--out`/data and `--out`/work unless `--data` / `--work` name others.
Exit code 0 only when the run is equivalent and healthy.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import serving_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_leg(a, work: str, kill_after: Optional[int] = None):
    """Run train_entry in a child process (at most `a.leg_timeout`
    seconds); SIGKILL it once it prints `Epoch {kill_after}:`. Returns
    (exit code, killed, output lines)."""
    cmd = [sys.executable, "-m", "gan_codes_tpu_torch.train_entry",
           "--data", a.data, "--image-size", str(a.image_size),
           "--batch-size", str(a.batch_size), "--epochs", str(a.epochs),
           "--dtype", a.dtype, "--n-channels", str(a.n_channels),
           "--device", a.device,
           "--images", os.path.join(work, "images"),
           "--weights", os.path.join(work, "weights")]
    if torch.device(a.device).type == "cuda":
        cmd.append("--deterministic")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")  # the kill reads live lines
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    expired = threading.Event()

    def expire():
        expired.set()
        proc.kill()

    timer = threading.Timer(a.leg_timeout, expire)
    timer.start()
    killed = False
    lines: List[str] = []
    try:
        n_logs = sum(f.startswith("log_") for f in os.listdir(work))
        with open(os.path.join(work, f"log_{n_logs}.txt"), "w") as log:
            for line in proc.stdout:
                log.write(line)
                lines.append(line)
                if line.startswith("Epoch ") or "Resuming" in line:
                    print(f"  [{os.path.basename(work)}] {line.rstrip()}",
                          flush=True)
                if (kill_after is not None and not killed
                        and line.startswith(f"Epoch {kill_after}:")):
                    print(f"  >>> SIGKILL after epoch {kill_after} "
                          "(a crash mid-run)", flush=True)
                    proc.send_signal(signal.SIGKILL)
                    killed = True
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        rc = proc.wait()
    if expired.is_set():
        raise RuntimeError(f"{work}: train_entry did not end within "
                           f"{a.leg_timeout} s:\n{''.join(lines[-20:])}")
    return rc, killed, lines


def _differences(x, y, path: str = "state") -> List[str]:
    """Paths where two checkpoint trees differ: tensors by dtype, shape
    and value bit for bit, everything else by ==."""
    if isinstance(x, dict) and isinstance(y, dict):
        if x.keys() != y.keys():
            return [f"{path}: keys {sorted(map(str, x.keys() ^ y.keys()))}"]
        return [d for k in x for d in _differences(x[k], y[k],
                                                   f"{path}.{k}")]
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        if len(x) != len(y):
            return [f"{path}: lengths {len(x)} != {len(y)}"]
        return [d for i, (u, v) in enumerate(zip(x, y))
                for d in _differences(u, v, f"{path}[{i}]")]
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        same = (x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x, y))
        return [] if same else [path]
    return [] if x == y else [path]


def final_state(work: str):
    """(checkpoint tree, histories, last epoch) of one leg."""
    weights = os.path.join(work, "weights")
    state = torch.load(os.path.join(weights, "checkpoint"),
                       map_location="cpu", weights_only=True)
    with open(os.path.join(weights, "histories.json")) as f:
        hist = json.load(f)
    return state, hist, int(hist.pop("epoch"))


def loss_health(hist: dict) -> dict:
    g = np.asarray(hist["g_losses"], np.float64)
    d = np.asarray(hist["d_losses"], np.float64)
    gp = np.asarray(hist["d_gp_losses"], np.float64)
    health = {
        "finite": bool(np.isfinite(g).all() and np.isfinite(d).all()
                       and np.isfinite(gp).all()),
        "d_loss_band": bool(np.all((d > 0.0) & (d < 4.0))),
        "g_loss_band": bool(np.all(np.abs(g) < 20.0)),
        "gp_nonnegative": bool(np.all(gp >= 0.0)),
        "d_loss_range": [float(d.min()), float(d.max())],
        "g_loss_range": [float(g.min()), float(g.max())],
    }
    health["ok"] = (health["finite"] and health["d_loss_band"]
                    and health["g_loss_band"] and health["gp_nonnegative"])
    return health


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--kill-after-epoch", type=int, default=14)
    ap.add_argument("--batch-size", type=int, default=24)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--n-channels", type=int, default=32)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--n-train", type=int, default=192)
    ap.add_argument("--n-test", type=int, default=48)
    ap.add_argument("--out", default="longrun_out")
    ap.add_argument("--data", default=None,
                    help="a CUB-format dir (default: --out/data, a "
                         "synthetic fixture made there if missing)")
    ap.add_argument("--work", default=None,
                    help="the legs' dirs (default: --out/work; emptied "
                         "first)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--leg-timeout", type=float, default=3600.0,
                    help="seconds each train_entry process may take")
    a = ap.parse_args(argv)
    serving_device(a.device)
    if not 0 < a.kill_after_epoch < a.epochs:
        ap.error("--kill-after-epoch must be in [1, --epochs)")
    a.out = os.path.abspath(a.out)
    a.data = os.path.abspath(a.data or os.path.join(a.out, "data"))
    a.work = os.path.abspath(a.work or os.path.join(a.out, "work"))

    # 1. a synthetic CUB-format fixture at the operating point
    if not os.path.exists(os.path.join(a.data, "captions.pickle")):
        from ..data.synthetic import make_synthetic_cub

        info = make_synthetic_cub(a.data, n_train=a.n_train,
                                  n_test=a.n_test,
                                  image_size=int(a.image_size * 76 / 64))
        print(f"fixture: {info}", flush=True)
    if os.path.exists(a.work):
        shutil.rmtree(a.work)

    # 2. the uninterrupted twin
    print(f"== leg A: straight {a.epochs} epochs ==", flush=True)
    t0 = time.time()
    straight = os.path.join(a.work, "straight")
    rc, _, _ = run_leg(a, straight)
    if rc != 0:
        raise RuntimeError(f"the straight leg failed, rc {rc}")
    t_straight = time.time() - t0

    # 3. killed, then resumed
    print(f"== leg B: SIGKILL after epoch {a.kill_after_epoch}, then "
          "resume ==", flush=True)
    resumed = os.path.join(a.work, "resumed")
    rc, killed, _ = run_leg(a, resumed, kill_after=a.kill_after_epoch)
    if not killed or rc != -signal.SIGKILL:
        raise RuntimeError(f"the kill was not delivered (killed {killed}, "
                           f"rc {rc})")
    rc, _, lines = run_leg(a, resumed)
    if rc != 0:
        raise RuntimeError(f"the resumed leg failed, rc {rc}")
    resume_line = next((l for l in lines if "Resuming" in l), None)
    if resume_line is None:
        raise RuntimeError("the resumed leg did not print 'Resuming'")

    # 4. equivalence: the final state and histories bit for bit
    sa, ha, ea = final_state(straight)
    sb, hb, eb = final_state(resumed)
    mismatches = _differences(sa, sb)
    if not (ea == eb == a.epochs - 1):
        mismatches.append(f"last epochs {ea}, {eb}")
    hist_equal = {k: ha[k] == hb.get(k) for k in ha}

    # 5. artifacts
    os.makedirs(a.out, exist_ok=True)
    shutil.copy(os.path.join(straight, "weights", "metrics_log.jsonl"),
                os.path.join(a.out, "metrics_straight.jsonl"))
    if importlib.util.find_spec("matplotlib") is not None:
        from ..utils.plotting import plot_losses

        plot_losses(ha["g_losses"], ha["d_losses"], ha["d_gp_losses"],
                    os.path.join(a.out, "loss_curves.png"))
    grid_dir = os.path.join(a.out, "sample_grids")
    os.makedirs(grid_dir, exist_ok=True)
    copied = []
    for e in sorted({0, a.epochs // 4, a.epochs // 2, 3 * a.epochs // 4,
                     a.epochs - 1}):
        for name in (f"fake_sample_epoch_{e}.png",
                     f"samples_with_text_epoch_{e}.jpg"):
            src = os.path.join(straight, "images", name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(grid_dir, name))
                copied.append(name)

    health = loss_health(ha)
    with open(os.path.join(a.out, "metrics_straight.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    epoch_secs = [r["epoch_seconds"] for r in rows if "epoch_seconds" in r]
    report = {
        "operating_point": {"image_size": a.image_size,
                            "batch_size": a.batch_size, "dtype": a.dtype,
                            "n_channels": a.n_channels, "epochs": a.epochs,
                            "n_train": a.n_train, "device": a.device},
        "straight_wall_seconds": t_straight,
        "epoch_seconds_first": epoch_secs[0],
        "epoch_seconds_steady_mean": float(np.mean(epoch_secs[1:])),
        "killed_after_epoch": a.kill_after_epoch,
        "resume_print": resume_line.strip(),
        "param_mismatches": mismatches,
        "histories_equal": hist_equal,
        "equivalent": not mismatches and all(hist_equal.values()),
        "sample_grids": copied,
        "loss_health": health,
    }
    with open(os.path.join(a.out, "LONGRUN.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    if not report["equivalent"]:
        print("LONGRUN FAILED: the resumed run is not equivalent",
              flush=True)
        return 1
    if not health["ok"]:
        print(f"LONGRUN FAILED: loss health outside its bands: {health}",
              flush=True)
        return 1
    if not copied:
        print("LONGRUN FAILED: the run wrote no sample grid", flush=True)
        return 1
    print("LONGRUN OK: kill-and-resume bit for bit; loss health in band; "
          f"{len(copied)} sample grids in {grid_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GALIP's step, device milliseconds (`Trainer.timers["step"]`, CUDA
events around each step), averaged over the window's steps."""
import math


def read(run):
    s = run.program.get("step_s_mean")
    return None if s is None or not math.isfinite(s) else 1e3 * s

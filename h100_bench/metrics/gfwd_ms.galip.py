"""GALIP's step, first part (span `step.g_forward`: the text tower, the
noise and G's forward with its mapper), device milliseconds a traced
step."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.g_forward", "device_s")

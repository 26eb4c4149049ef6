"""The train step's first part (span `step.g_forward`: the text encoder,
the noise and G's forward), device milliseconds a traced step."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.g_forward", "device_s")

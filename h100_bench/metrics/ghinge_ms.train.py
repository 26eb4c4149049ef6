"""Phase 3, G's hinge step (span `step.g_hinge`: D's forward on the fakes,
G's backward, clip, Adam, the EMA and the metrics), device milliseconds a
traced step."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.g_hinge", "device_s")

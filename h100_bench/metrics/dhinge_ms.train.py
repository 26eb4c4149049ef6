"""Phase 1, D's hinge step (span `step.d_hinge`: D's forward and backward
on the real, fake and mismatched pairs, clip and Adam), device milliseconds
a traced step."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.d_hinge", "device_s")

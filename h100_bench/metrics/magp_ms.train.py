"""Phase 2, MA-GP (span `step.magp`: the penalty's double backward through
D, clip and Adam), device milliseconds a traced step that ran it."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.magp", "device_s")

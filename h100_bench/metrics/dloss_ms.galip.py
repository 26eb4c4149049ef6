"""GALIP's D update (span `step.d_loss`: two CLIP image encodes, NetD and
NetC, the hinge, the MA-GP's double backward, Adam), device milliseconds
a traced step."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.d_loss", "device_s")

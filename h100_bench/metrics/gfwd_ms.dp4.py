"""The data-parallel train step's first part (the text encoder, the noise and G's forward), span `step.g_forward` on rank 0,
device milliseconds a traced step.
The rank's spans come back in `run.program["spans"]`."""
from h100_bench.rank_spans import ms_per


def read(run):
    return ms_per(run, "step.g_forward")

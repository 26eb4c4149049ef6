"""The data-parallel train step's phase 3 (G's hinge against the updated D), span `step.g_hinge` on rank 0
(its gradient all-reduce included), device milliseconds a traced step.
The rank's spans come back in `run.program["spans"]`."""
from h100_bench.rank_spans import ms_per


def read(run):
    return ms_per(run, "step.g_hinge")

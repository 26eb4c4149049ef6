"""The data-parallel train step's phase 1 (D's hinge on real, fake and mismatched pairs), span `step.d_hinge` on rank 0
(its gradient all-reduce included), device milliseconds a traced step.
The rank's spans come back in `run.program["spans"]`."""
from h100_bench.rank_spans import ms_per


def read(run):
    return ms_per(run, "step.d_hinge")

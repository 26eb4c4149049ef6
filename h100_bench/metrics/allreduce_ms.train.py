"""The data-parallel step's gradient all-reduces (span `dp.all_reduce`,
one a phase, device-timed on rank 0's step stream: the wait for the
slowest rank included), device milliseconds a traced step of rank 0.
The rank's spans come back in `run.program["spans"]`."""
from h100_bench.rank_spans import ms_per


def read(run):
    return ms_per(run, "dp.all_reduce", "train.step")

"""GALIP's launching thread, wall milliseconds in a traced step (span
`train.step`, host clock): where it exceeds the step's device time, the
card waits for the host."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "train.step", "host_s")

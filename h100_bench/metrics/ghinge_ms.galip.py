"""GALIP's G update (span `step.g_hinge`: the CLIP encode of the fakes,
NetD and NetC, their input gradients, G's backward through the mapper
and K2, Adam, the EMA), device milliseconds a traced step."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "step.g_hinge", "device_s")

"""The host's milliseconds a traced call spent enqueueing its batches (span
`sampler.launch`: the noise, the text encoder and G's forward), over the
calls (`sampler.generate`)."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "sampler.launch", "host_s", "sampler.generate")

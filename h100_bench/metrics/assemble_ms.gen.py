"""The host's milliseconds a traced call spent assembling its images into
one array (span `sampler.assemble`: the padding, each batch's and the last
numpy concatenation), over the calls (`sampler.generate`)."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "sampler.assemble", "host_s", "sampler.generate")

"""The host's milliseconds a traced call spent copying its images to the
host (span `sampler.to_host`: the wait for the device, then the copy to
pageable memory), over the calls (`sampler.generate`)."""
from h100_bench.spans import ms_per


def read(run):
    return ms_per(run, "sampler.to_host", "host_s", "sampler.generate")

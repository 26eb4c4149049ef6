"""The 95th percentile latency (ms) of the window's requests, on the
client's clock from when each was due (sent, in a closed loop) to its
last byte; a failed request counts at the timeout."""


def read(run):
    return run.e2e.get("serve_p95_ms")

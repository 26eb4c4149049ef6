"""The device's idle share of GALIP's traced steps: 1 - busy / window."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""cuDNN's convolution kernels (forward, data and weight gradients: D's
and G's convs, MA-GP's weight terms among them), device milliseconds per
traced step."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    s = t.seconds("cuDNN conv fwd", "cuDNN conv dgrad", "cuDNN conv wgrad")
    return 1e3 * s / t.units if s > 0 else None

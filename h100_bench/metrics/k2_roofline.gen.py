"""K2 (`fused_modconv3x3`) against its roofline: the least time of the
14 DFBlock modulated convs of the traced calls (`flops.k2_work`, each
launch bound by operations or bytes) over the device time of the kernels
named `fused_modconv3x3`, in percent."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    spent = t.seconds_named("fused_modconv3x3")
    if spent <= 0:
        return None
    least = run.flops.k2_work(run.cfg, run.mix["batch"])["bound_s"]
    return 100.0 * least * t.units / spent

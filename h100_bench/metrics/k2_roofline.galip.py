"""K2 (`fused_modconv3x3`) against its roofline in GALIP's step: the least
time of the ten G_Block DFBlock convs of a step's G forward
(`flops_galip.k2_work`, each launch bound by operations or bytes) over
the device time of the kernels named `fused_modconv3x3`, in percent."""
from h100_bench import flops_galip


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    spent = t.seconds_named("fused_modconv3x3")
    if spent <= 0:
        return None
    least = flops_galip.k2_work(run.cfg,
                                run.cfg["train"]["batch_size"])["bound_s"]
    return 100.0 * least * t.units / spent

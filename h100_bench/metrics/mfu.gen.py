"""The generator forward's model operations
(`flops.generator_forward_flops`) at the window's img/s, over the
configuration's peak, in percent."""


def read(run):
    rate = run.e2e.get("gen_img_per_s")
    if not rate:
        return None
    f = run.flops
    return 100.0 * f.generator_forward_flops(run.cfg) * rate / f.peak_flops(
        run.cfg)

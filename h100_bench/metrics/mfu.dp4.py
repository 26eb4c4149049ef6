"""The data-parallel train step's model operations
(`flops.train_step_flops`) at the window's global img/s, over the peak of
the cell's cards (`ranks` of the traffic mix, each at the
configuration's peak), in percent."""


def read(run):
    rate = run.e2e.get("train_img_per_s")
    ranks = run.mix.get("ranks")
    if not rate or not ranks:
        return None
    f = run.flops
    per_image = f.train_step_flops(run.cfg) / run.cfg["train"]["batch_size"]
    return 100.0 * per_image * rate / (int(ranks) * f.peak_flops(run.cfg))

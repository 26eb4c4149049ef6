"""The train step's model operations (`flops.train_step_flops`) at the
window's img/s, over the configuration's peak, in percent."""


def read(run):
    rate = run.e2e.get("train_img_per_s")
    if not rate:
        return None
    f = run.flops
    per_image = f.train_step_flops(run.cfg) / run.cfg["train"]["batch_size"]
    return 100.0 * per_image * rate / f.peak_flops(run.cfg)

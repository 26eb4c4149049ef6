"""GALIP's step operations (`flops_galip.train_step_flops`) at the
window's img/s, over the configuration's peak (one TF32 pass: 495
TFLOP/s), in percent."""
from h100_bench import flops, flops_galip


def read(run):
    rate = run.e2e.get("train_img_per_s")
    if not rate:
        return None
    per_image = (flops_galip.train_step_flops(run.cfg)
                 / run.cfg["train"]["batch_size"])
    return 100.0 * per_image * rate / flops.peak_flops(run.cfg)

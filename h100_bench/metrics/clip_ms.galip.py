"""The CLIP towers' forward passes in GALIP's step: device milliseconds a
traced step under the spans `clip.text`, `clip.image` (every visual
encode) and `galip.mapper` (the mapper inside G), over the steps (span
`train.step`). Their backward passes run outside these spans."""
from h100_bench.spans import ms_per


def read(run):
    parts = [ms_per(run, name, "device_s", unit="train.step")
             for name in ("clip.text", "clip.image", "galip.mapper")]
    if any(p is None for p in parts):
        return None
    return sum(parts)

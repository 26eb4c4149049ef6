"""The readers of the program's spans: a traced run of the gen cell and of
a train cell at tiny sizes on the CPU reports each of them as a finite
number, and a reader gives None where the registry holds nothing or the
program has none."""
import math

import pytest

from h100_bench import core

SEED = 2**31 + 23
TRAIN = ("gfwd_ms.train", "dhinge_ms.train", "magp_ms.train",
         "ghinge_ms.train", "launch_ms.train")
GEN = ("launch_ms.gen", "to_host_ms.gen", "assemble_ms.gen")
SPANS = ("train.step", "step.g_forward", "step.d_hinge", "step.magp",
         "step.g_hinge", "sampler.generate", "sampler.launch",
         "sampler.to_host", "sampler.assemble")


@pytest.mark.parametrize("cell, names", [("cub256-tf32-gen", GEN),
                                         ("cub256-fp32-train", TRAIN)])
def test_traced_run_reports_the_span_metrics(cell, names, tiny, bench):
    from gan_codes_tpu_torch.utils.profiling import reset_spans

    reset_spans()
    r = core.run_cell(cell, SEED, 1.0, True, device="cpu", spec=bench,
                      size=tiny)
    for name in names:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
        assert r["metrics"][name]["unit"] == "ms"
    reset_spans()


def _run(traced):
    win = core.Window(e2e={}, attempted=0, failed=0, program={},
                      trace=object() if traced else None,
                      memory_peak_bytes=0, checks={}, seconds=1.0)
    return core.Run("cell", {}, {}, win)


def test_reader_without_spans_gives_none(bench, monkeypatch):
    """A traced run with an empty registry gives None; so do a run without
    a traced block, whatever the registry holds, and a program without
    the registry."""
    import torch

    from gan_codes_tpu_torch.utils import profiling

    profiling.reset_spans()
    for name in TRAIN + GEN:
        assert bench.reader(name)(_run(True)) is None, name
    with torch.profiler.profile():
        for span in SPANS:
            with profiling.span(span, "cpu"):
                pass
    for name in TRAIN + GEN:
        assert bench.reader(name)(_run(False)) is None, name
        assert bench.reader(name)(_run(True)) >= 0, name
    monkeypatch.delattr(profiling, "span_summary")
    for name in TRAIN + GEN:
        assert bench.reader(name)(_run(True)) is None, name
    profiling.reset_spans()

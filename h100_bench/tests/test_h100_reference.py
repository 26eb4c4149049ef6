"""The plain reference against the port at a tiny size on the CPU: the
modules on the same weights, and whole cells, whose runs compare the
port's timed path with the reference."""
import numpy as np
import pytest
import torch

from h100_bench import core, spec as spec_mod, weights
from h100_bench.drivers import common
from h100_bench.reference import dfgan


@pytest.fixture
def cfg(tiny):
    spec = spec_mod.Spec()
    return core.merge(spec.config("dfgan-cub256-fp32"), tiny["cfg"])


def test_modules_match_the_port(cfg):
    from gan_codes_tpu_torch.models.discriminator import Discriminator
    from gan_codes_tpu_torch.models.generator import Generator
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder

    pcfg = common.port_config(cfg)
    sd = {m: weights.make(cfg, m, 5, "cpu") for m in weights.LEAVES}
    g, d = Generator(pcfg.generator), Discriminator(pcfg.discriminator)
    te = RNNEncoder(pcfg.text_encoder)
    for mod, name in ((g, "generator"), (d, "discriminator"),
                      (te, "text_encoder")):
        mod.load_state_dict(sd[name])  # strict: the same names and shapes
    gen = torch.Generator().manual_seed(0)
    caps = torch.randint(2, 60, (6, 18), generator=gen)
    lens = torch.tensor([1, 5, 18, 9, 12, 3])
    caps[torch.arange(18)[None, :] >= lens[:, None]] = 0
    noise = torch.randn(6, 8, generator=gen)
    with torch.no_grad():
        s_port = te(caps, lens)
        s_ref = dfgan.text_encode(sd["text_encoder"], caps, lens)
        torch.testing.assert_close(s_port, s_ref, rtol=1e-5, atol=1e-6)
        img = g(noise, s_ref)
        ref = dfgan.generator(sd["generator"], noise, s_ref)
        torch.testing.assert_close(img, ref.permute(0, 2, 3, 1), rtol=1e-4,
                                   atol=1e-5)
        assert 0.05 < img.std() < 0.95  # not saturated, not flat
        logit = d(img, s_ref).reshape(-1)
        want = dfgan.d_logits(sd["discriminator"], dfgan.d_embeds(
            sd["discriminator"], ref), s_ref)
        torch.testing.assert_close(logit, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell", ["cub256-fp32-train", "cub256-tf32-train",
                                  "cub256-tf32-gen", "cub256-fp32-serve"])
def test_cells_are_correct_at_a_tiny_size(cell, tiny, bench):
    r = core.run_cell(cell, 2**31 + 17, 1.0, False, device="cpu",
                      spec=bench, size=tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(np.isfinite(m["value"]) for m in r["metrics"].values())


def test_serve_cell_reads_its_metrics(tiny, bench):
    """The serving cell, closed loop, reports its images a second and,
    traced, every per-layer metric of its own."""
    r = core.run_cell("cub256-fp32-serve", 2**31 + 19, 1.0, False,
                      device="cpu", spec=bench, size=tiny)
    assert r["metrics"]["serve_img_per_s"]["value"] > 0
    r = core.run_cell("cub256-fp32-serve", 2**31 + 19, 1.0, True,
                      device="cpu", spec=bench, size=tiny)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in bench.per_layer("cub256-fp32-serve")}
    # the CPU's trace has no device time: only the device's idle share
    # finds nothing to read
    assert set(r["metrics"]) == want - {"idle_pct.serve"}

"""The GALIP configuration and the two cells added beside DF-GAN's: the
manifest's rules for them (a four-chip cell among them), GALIP's work
counts against a count by hand, the GALIP reference against the port at
a tiny size, and both cells run whole on the CPU at tiny sizes."""
import json
import math
import re

import pytest
import torch

from h100_bench import core, flops_galip, spec as spec_mod, weights_galip
from h100_bench.reference import galip as ref

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
GALIP = "galip-cub224-tf32-train"
DP4 = "cub256-fp32-train-dp4"
NEW_METRICS = ("gfwd_ms.galip", "dloss_ms.galip", "ghinge_ms.galip",
               "clip_ms.galip", "k2_roofline.galip", "mfu.galip",
               "idle_pct.galip", "data_wait_pct.galip", "launch_ms.galip",
               "step_ms.galip")
DP4_METRICS = ("gfwd_ms.dp4", "dhinge_ms.dp4", "magp_ms.dp4",
               "ghinge_ms.dp4", "mfu.dp4")

# the GALIP cell at a tiny size: 32 px, nf 8, a CLIP 32 wide, batch 4
TINY_GALIP = {
    "cfg": {"generator": {"n_channels": 8, "image_size": 32, "code_ch": 16,
                          "mid_ch": 8, "sentence_dim": 32},
            "discriminator": {"n_channels": 8, "sentence_dim": 32},
            "text_encoder": {"embed_dim": 32, "vision_width": 32,
                             "transformer_width": 32,
                             "transformer_heads": 2},
            "train": {"batch_size": 4}, "data": {"image_size": 32}},
    "mix": {"images": 16, "width": [40, 60], "height": [32, 60],
            "decode_threads": 2}}


@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec()


def test_the_new_cells_follow_the_manifest_rules(spec):
    m = spec.manifest
    cells = {c["name"]: c for c in m["workloads"]}
    assert cells[DP4]["chips"] == 4 and cells[GALIP]["chips"] == 1
    assert cells[DP4]["config"] == "dfgan-cub256-fp32"
    assert cells[GALIP]["config"] == "galip-cub224-tf32"
    for c in m["workloads"]:
        assert c["chips"] in (1, 4)
        assert 1 <= len(c["why"]) <= 200 and NAME.match(c["name"])
    four = sum(c["chips"] == 4 for c in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
    galip = [c for c in m["configs"] if c["name"] == "galip-cub224-tf32"][0]
    assert galip["reduced"] == [] and len(galip["source"]) <= 200
    assert set(galip) == {"name", "source", "file", "reduced", "why"}
    for cell in (DP4, GALIP):
        e2e = {x["name"] for x in spec.end_to_end(cell)}
        assert e2e == {"train_img_per_s", "setup_s"}
        assert spec.per_layer(cell)
        assert spec.cell_file(cell)["limits"]
    assert {x["name"] for x in spec.per_layer(GALIP)} == set(NEW_METRICS)
    assert {"allreduce_ms.train", *DP4_METRICS} <= {
        x["name"] for x in spec.per_layer(DP4)}
    # a full check of the benchmark fits in its 43200 s
    n = len(m["workloads"])
    assert ((2 + 14 * n) * (m["run_seconds"] + 60) + n * 180 + 1200
            <= 43200)


def test_the_galip_file_is_the_port_s_config(spec):
    from gan_codes_tpu_torch.config import GALIPConfig

    cfg = spec.config("galip-cub224-tf32")
    port = GALIPConfig.from_dict(cfg)
    assert port.generator.block_channels == ((512, 512), (512, 512),
                                             (512, 256), (256, 128),
                                             (128, 64))
    assert port.generator.block_sizes == (8, 16, 32, 64, 224)
    assert port.text_encoder.vision_width == 768
    assert port.discriminator.local_layers == (1, 4, 8)


SMALL = {"precision": "tf32", "train": {"batch_size": 2},
         "generator": {"n_channels": 1, "latent_dim": 2, "sentence_dim": 2,
                       "image_size": 32, "code_ch": 2, "mid_ch": 1,
                       "n_mblocks": 1, "n_prompts": 1},
         "discriminator": {"n_channels": 1, "sentence_dim": 2,
                           "local_layers": [0, 1]},
         "text_encoder": {"embed_dim": 2, "image_resolution": 4,
                          "vision_layers": 2, "vision_width": 4,
                          "vision_patch_size": 2, "context_length": 3,
                          "transformer_width": 2, "transformer_layers": 1}}


def test_galip_work_counts_by_hand():
    """At nf 1, 32 px, a 2 x 2 CLIP grid of width 4 (5 tokens), one
    M_Block, one prompt, a 3-token text tower of width 2."""
    # a block: 2 (12 T W^2 + 2 T^2 W)
    assert flops_galip.transformer_ops(4, 5) == 2 * (12 * 5 * 16
                                                     + 2 * 25 * 4)
    text = 1 * 2 * (12 * 3 * 4 + 2 * 9 * 2) + 2 * 2 * 2
    assert flops_galip.text_forward(SMALL) == text
    image = 2 * 4 * 3 * 4 * 4 + 2 * 2 * (12 * 5 * 16 + 2 * 25 * 4) \
        + 2 * 4 * 2
    assert flops_galip.image_forward(SMALL) == image
    # the mapper: block 0 on 5 tokens, block 1 on 6 (the prompt)
    mapper = 2 * (12 * 5 * 16 + 2 * 25 * 4) + 2 * (12 * 6 * 16
                                                   + 2 * 36 * 4)
    assert flops_galip.mapper_forward(SMALL) == mapper
    # G: ladder 8 -> 4 -> 2 -> 1 (log2(32) - 1 = 4 widths) at 8, 16, 32
    assert weights_galip.g_block_channels(SMALL["generator"]) == [
        (8, 4), (4, 2), (2, 1)]
    assert weights_galip.g_block_sizes(SMALL["generator"]) == [8, 16, 32]
    cond = 4

    def affine(c):  # two affines, two MLPs each: cond -> c -> c
        return 4 * 2 * cond * c + 4 * 2 * c * c

    g = (2 * 2 * 4 * 2 + 2 * cond * 4 * 1            # fc_code, fc_prompt
         + 2 * 4 * 9 * 2 * 1 + 2 * 4 * 9 * 1 * 2       # M_Block convs
         + affine(1) + affine(2)
         + 2 * 4 * 25 * 2 * 4 + mapper + 2 * 4 * 25 * 4 * 8)
    for (ci, co), s in ((8, 4), 8), ((4, 2), 16), ((2, 1), 32):
        g += affine(ci) + affine(co) + 2 * s * s * 9 * ci * co \
            + 2 * s * s * 9 * co * co + 2 * s * s * ci * co
    g += 2 * 32 * 32 * 9 * 1 * 3
    assert flops_galip.generator_forward_flops(SMALL) == g
    # K2: the six G_Block DFBlocks
    assert flops_galip.dfblock_shapes(SMALL) == [
        (8, 8, 4), (8, 4, 4), (16, 4, 2), (16, 2, 2), (32, 2, 1),
        (32, 1, 1)]
    k2 = flops_galip.k2_work(SMALL, 2)
    assert k2["flops"] == sum(2 * 2 * s * s * 9 * i * o for s, i, o in
                              flops_galip.dfblock_shapes(SMALL))


def test_galip_work_at_the_published_widths(spec):
    """About 160 GFLOP an image a step (G's forward about 33, one CLIP
    image encode 8.8, the text tower 6.0)."""
    cfg = spec.config("galip-cub224-tf32")
    per_image = flops_galip.train_step_flops(cfg) / 64
    assert 150e9 < per_image < 175e9
    assert math.isclose(flops_galip.image_forward(cfg), 8.818e9, rel_tol=1e-3)
    assert math.isclose(flops_galip.text_forward(cfg), 5.960e9, rel_tol=1e-3)
    assert 32e9 < flops_galip.generator_forward_flops(cfg) < 34e9


@pytest.fixture
def fp32():
    """The port's fp32 precision at "highest" (an earlier cell may have
    left one TF32 pass set), restored after the test."""
    from gan_codes_tpu_torch.utils.device import set_matmul_precision

    previous = set_matmul_precision("highest")
    yield
    set_matmul_precision(previous)


def test_the_reference_matches_the_port_at_a_tiny_size(fp32):
    from gan_codes_tpu_torch.config import GALIPConfig
    from gan_codes_tpu_torch.data.dataset import frame_clip
    from gan_codes_tpu_torch.models import galip
    from gan_codes_tpu_torch.models.clip import CLIP

    spec = spec_mod.Spec()
    cfg = core.merge(spec.config("galip-cub224-tf32"), TINY_GALIP["cfg"])
    port = GALIPConfig.from_dict(cfg)
    sd = {m: weights_galip.make(cfg, m, 3, "cpu")
          for m in weights_galip.LEAVES}
    clip = CLIP(port.text_encoder)
    clip.load_state_dict(sd["clip"])
    g, d = galip.build(port, clip)
    g.load_state_dict(sd["generator"])
    d.load_state_dict(sd["discriminator"])
    ids = torch.stack([torch.from_numpy(frame_clip(
        torch.arange(5, 5 + n).numpy(), 77, 49406, 49407)[0])
        for n in (4, 30)])
    noise = torch.randn(2, 100, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        s = ref.encode_text(sd["clip"], ids, 2)
        torch.testing.assert_close(clip(ids), s, rtol=2e-5, atol=2e-5)
        img = ref.generator(sd["generator"], sd["clip"], noise, s, cfg)
        torch.testing.assert_close(g(noise, s), img.permute(0, 2, 3, 1),
                                   rtol=2e-5, atol=2e-5)
        loc, _ = ref.encode_image(sd["clip"], img, 1)
        want = ref.net_c(sd["discriminator"], ref.net_d(
            sd["discriminator"], loc), s)
        got = d.logits(loc.permute(0, 1, 3, 4, 2), s).reshape(-1)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_the_galip_cell_is_correct_at_a_tiny_size():
    r = core.run_cell(GALIP, 2**31 + 23, 1.0, False, device="cpu",
                      size=TINY_GALIP)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_img_per_s", "setup_s"}


def test_the_galip_cell_reads_its_span_metrics_traced():
    r = core.run_cell(GALIP, 2**31 + 29, 1.0, True, device="cpu",
                      size=TINY_GALIP)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    # the CPU's trace has no device time: the readers of device kernels
    # and of the idle share find nothing
    assert set(got) == set(NEW_METRICS) - {"k2_roofline.galip",
                                           "idle_pct.galip"}
    phases = sum(got[k]["value"] for k in ("gfwd_ms.galip", "dloss_ms.galip",
                                           "ghinge_ms.galip"))
    assert 0 < got["clip_ms.galip"]["value"] <= phases


def test_the_dp4_cell_runs_four_gloo_ranks_at_a_tiny_size(tiny):
    """Four rank processes over gloo on the CPU: correct against the
    reference at the global batch, the ranks bit-equal (rank_gap 0), and
    traced, the all-reduce span read."""
    size = {"cfg": tiny["cfg"], "mix": dict(tiny["mix"], images=48)}
    r = core.run_cell(DP4, 2**31 + 31, 1.0, True, device="cpu", size=size)
    assert r["correct"], r["checks"]
    assert r["checks"]["rank_gap"]["value"] == 0.0
    assert r["device"]["count"] == 4
    assert r["metrics"]["allreduce_ms.train"]["value"] > 0
    for name in DP4_METRICS:  # rank 0's phases, the four cards' share
        assert r["metrics"][name]["value"] > 0, name
    assert json.dumps(r)

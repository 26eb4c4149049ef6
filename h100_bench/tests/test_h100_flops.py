"""The work counts against a count by hand at n_channels 1, 16px."""
import pytest

from h100_bench import flops

SMALL = {"precision": "float32",
         "generator": {"n_channels": 1, "latent_dim": 2, "sentence_dim": 2,
                       "affine_hidden": 2, "image_size": 16,
                       "base_size": 4},
         "discriminator": {"n_channels": 1, "final_size": 4},
         "train": {"batch_size": 2}}


def mlps(c):
    # four affine blocks a G block, each two MLPs: s->hid (2*2*2 a MLP)
    # and hid->c (2*2*c a MLP)
    return 2 * (2 * 2 * 2) + 2 * (2 * 2 * c)


# G blocks (Cin -> Cout at R): 8->4 at 4, 4->2 at 8, 2->1 at 16
G_BLOCKS = [
    mlps(8) * 2 + mlps(4) * 2 + 2 * 16 * 9 * 8 * 4 + 2 * 16 * 9 * 4 * 4
    + 2 * 16 * 8 * 4,
    mlps(4) * 2 + mlps(2) * 2 + 2 * 64 * 9 * 4 * 2 + 2 * 64 * 9 * 2 * 2
    + 2 * 64 * 4 * 2,
    mlps(2) * 2 + mlps(1) * 2 + 2 * 256 * 9 * 2 * 1 + 2 * 256 * 9 * 1 * 1
    + 2 * 256 * 2 * 1,
]
LINEAR_IN = 2 * 2 * 8 * 16
TO_RGB = 2 * 256 * 9 * 1 * 3
G_FWD = LINEAR_IN + sum(G_BLOCKS) + TO_RGB
# D: stem 3->1 at 16; blocks 1->2 (16->8), 2->4 (8->4); logits (4+2)->2
STEM = 2 * 256 * 9 * 3 * 1
D_REST = (2 * 64 * 16 * 1 * 2 + 2 * 64 * 9 * 2 * 2 + 2 * 256 * 1 * 2
          + 2 * 16 * 16 * 2 * 4 + 2 * 16 * 9 * 4 * 4 + 2 * 64 * 2 * 4)
LOGITS = 2 * 16 * 9 * 6 * 2 + 2 * 2 * 1 * 16


def test_generator_forward():
    assert G_FWD == 59408
    assert flops.generator_forward_flops(SMALL) == pytest.approx(G_FWD)


def test_train_step():
    # G: forward + weight gradients everywhere, input gradients except at
    # linear_in and the MLPs' first layers (their inputs need none)
    mlp0 = 12 * 2 * 2 * 2 * 2
    g = 3 * G_FWD - LINEAR_IN - mlp0
    emb = STEM + D_REST
    phase1 = 2 * (3 * emb - STEM) + 5 / 2 * 3 * LOGITS
    phase2 = 4 * (emb + LOGITS)
    phase3 = 2 * (emb + LOGITS)
    want = 2 * (g + phase1 + phase2 + phase3)
    assert flops.train_step_flops(SMALL) == pytest.approx(want)


def test_k2_work():
    shapes = [(4, 8, 4), (4, 4, 4), (8, 4, 2), (8, 2, 2), (16, 2, 1),
              (16, 1, 1)]
    assert flops.dfblock_shapes(SMALL) == shapes
    w = flops.k2_work(SMALL, batch=1)
    assert w["flops"] == pytest.approx(41472)
    assert w["bytes"] == pytest.approx(4 * (516 + 292 + 474 + 302 + 795
                                            + 526))
    least = sum(max((r * r * i + 4 * i + 9 * i * o + o + r * r * o) * 4
                    / flops.H100_HBM_BYTES_PER_S,
                    2 * r * r * 9 * i * o / (495e12 / 3))
                for r, i, o in shapes)
    assert w["bound_s"] == pytest.approx(least)


def test_peaks():
    assert flops.peak_flops({"precision": "float32"}) == pytest.approx(165e12)
    assert flops.peak_flops({"precision": "tf32"}) == pytest.approx(495e12)

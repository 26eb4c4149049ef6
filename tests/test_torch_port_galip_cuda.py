"""GALIP on a card: kernel K2 at GALIP's G_Block shapes (512 input
channels, a 224 x 224 output) against its plain version, and a GALIP
train step at the published widths against the plain reference
(`h100_bench/reference/galip.py`).

Every test here is marked `cuda` and skips without a CUDA device. On a
machine with one (and nvcc):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_galip_cuda.py
"""
import numpy as np
import pytest
import torch

from gan_codes_tpu_torch.ops.kernels import fused_modconv
from gan_codes_tpu_torch.utils import device as pdevice
from torch_port_env import one_thread_children  # noqa: E402,F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and launch the "
                    "kernel")
    previous = pdevice.set_matmul_precision("highest")
    yield torch.device("cuda")
    pdevice.set_matmul_precision(previous)


def _k2_inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    vecs = [rng.standard_normal((b, cin)).astype(np.float32)
            for _ in range(4)]
    bound = (9 * cin) ** -0.5
    wt = rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
    return [x] + vecs + [wt, bias]


@pytest.mark.cuda
@pytest.mark.parametrize("one_pass", [False, True])
@pytest.mark.parametrize("dims", [(4, 8, 8, 512, 512), (2, 32, 32, 512, 256),
                                  (2, 224, 224, 128, 64),
                                  (2, 224, 224, 64, 64)])
def test_k2_at_galip_shapes(cuda, dims, one_pass):
    """K2 at GALIP's widths: Cin 512 (the 8 x 8 and 32 x 32 blocks) and the
    224 x 224 block (a size that is not a power of two), in 3xTF32
    (allclose 1e-4 with the fp32 plain version) and one TF32 pass
    (allclose 1e-4 with the plain version of that mode); a repeat gives
    the same bits."""
    args = [torch.from_numpy(a).to(cuda) for a in _k2_inputs(*dims)]
    if one_pass:
        pdevice.set_matmul_precision("high")
    before = fused_modconv.fused_modconv3x3.launches
    got = fused_modconv.fused_modconv3x3(*args)
    again = fused_modconv.fused_modconv3x3(*args)
    want = fused_modconv.reference_modconv3x3(*args, tf32=one_pass)
    torch.cuda.synchronize()
    assert fused_modconv.fused_modconv3x3.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_galip_step_on_the_card_against_the_reference(cuda):
    """One GALIP step at the published widths (batch 4, 224 px, CLIP
    ViT-B/32 widths) in fp32 against the reference's on the same weights,
    images, captions and noise: the losses within 1e-4 of their size, the
    gradients by leaf within 1e-2 of the module's median leaf, and every
    G_Block's DFBlocks on K2 (10 launches)."""
    import json
    import os

    from gan_codes_tpu_torch.config import GALIPConfig
    from gan_codes_tpu_torch.data.dataset import frame_clip
    from gan_codes_tpu_torch.models.clip import CLIP
    from gan_codes_tpu_torch.train.state import create_train_state
    from gan_codes_tpu_torch.train.step import make_train_step
    from h100_bench import weights_galip
    from h100_bench.reference import galip as ref

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "h100_bench", "configs",
                           "galip-cub224-tf32.json")) as f:
        bcfg = json.load(f)
    bcfg["train"]["batch_size"] = 4
    cfg = GALIPConfig.from_dict(bcfg)
    sd = {m: weights_galip.make(bcfg, m, 7, cuda) for m in
          weights_galip.LEAVES}
    clip = CLIP(cfg.text_encoder).to(cuda)
    clip.load_state_dict(sd["clip"])
    st = create_train_state(cfg, 0, device=cuda, clip=clip)
    st.generator.load_state_dict(sd["generator"])
    st.g_ema.load_state_dict(sd["generator"])
    st.discriminator.load_state_dict(sd["discriminator"])
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([
        frame_clip(rng.integers(0, 49406, n), 77, 49406, 49407)[0]
        for n in (5, 18, 30, 75)])).to(cuda)
    images = torch.rand((4, 224, 224, 3), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1)) * 2 - 1
    st.rng.manual_seed(3)
    before = fused_modconv.fused_modconv3x3.launches
    got = make_train_step(cfg)(st, clip, images, ids, None)
    assert fused_modconv.fused_modconv3x3.launches - before == 10
    rs = ref.TrainState(bcfg, sd["generator"], sd["discriminator"],
                        sd["clip"],
                        torch.Generator(device=cuda).manual_seed(3))
    want = ref.train_step(rs, images.permute(0, 3, 1, 2), ids)
    for k in ("d_loss", "d_gp_loss", "g_loss"):
        assert abs(float(got[k]) - want[k]) <= 1e-4 * max(abs(want[k]),
                                                         1e-3), k
    for prefix, module, opt, ref_params, ref_opt in (
            ("g", st.generator, st.g_opt, rs.g, rs.g_opt),
            ("d", st.discriminator, st.d_opt, rs.d, rs.d_opt)):
        got_g = {n: opt.adam.state[p]["exp_avg"] for (n, _), p in
                 zip(module.named_parameters(), opt.params)}
        want_g = dict(zip(ref_params, ref_opt.first))
        assert set(got_g) == set(want_g)
        med = float(torch.stack([g.double().norm()
                                 for g in want_g.values()]).median())
        for n, b in want_g.items():
            gap = float((got_g[n].double() - b.double()).norm())
            assert gap <= 1e-2 * max(float(b.double().norm()), med), \
                (prefix, n, gap)

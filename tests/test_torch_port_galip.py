"""GALIP in the port (`models/clip.py`, `models/galip.py`, `train/step.py::
make_galip_step`, `train/losses.py`) against the plain reference
`h100_bench/reference/galip.py` on the CPU, at 32 px with a CLIP 32 wide
and 12 layers deep, on seeded random weights in which every gamma and beta
is live (`h100_bench/weights_galip.py`).

Tolerances, each with its reason: the towers, G, D + C and the losses
within 2e-5 of their largest value (fp32 both sides; the port's
attention is `scaled_dot_product_attention` and its convolutions run
NHWC, the reference's softmax and NCHW: the same products summed in
another order); the gradients of one step by leaf within 1e-4 of the
module's median leaf (the same, through a double backward and Adam's
first moment). A reference computed in bfloat16 fails the first.

Also: the nearest resize against `F.interpolate`, CLIP's token framing,
a GALIP trainer's checkpoint resumed bit for bit, `train_entry --config`
training GALIP, and DF-GAN's step unchanged bit for bit by the refactor
that made room for GALIP's (the step as it was:
`tests/torch_port_dfgan_before.py`).
"""
import dataclasses
import gc
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_codes_tpu_torch.config import (CLIPConfig, GALIPConfig,
                                        GALIPDiscriminatorConfig,
                                        GALIPGeneratorConfig, GANConfig,
                                        TrainConfig, config_from_dict)
from gan_codes_tpu_torch.data.dataset import frame_clip
from gan_codes_tpu_torch.models import galip
from gan_codes_tpu_torch.models.clip import CLIP
from gan_codes_tpu_torch.ops import nn as ops_nn
from gan_codes_tpu_torch.parallel.mesh import Mesh
from gan_codes_tpu_torch.train import losses
from gan_codes_tpu_torch.train.state import create_train_state
from gan_codes_tpu_torch.train.step import make_train_step
from h100_bench import weights_galip
from h100_bench.reference import galip as ref
from torch_port_env import one_thread_children  # noqa: E402,F401

import torch_port_dfgan_before

CFG = GALIPConfig(
    generator=GALIPGeneratorConfig(n_channels=8, image_size=32, code_ch=16,
                                   mid_ch=8, sentence_dim=32),
    discriminator=GALIPDiscriminatorConfig(n_channels=8, sentence_dim=32),
    text_encoder=CLIPConfig(embed_dim=32, vision_width=32,
                            transformer_width=32, transformer_heads=2),
    train=TrainConfig(batch_size=4))
D = dataclasses.asdict(CFG)
B = 4
TOL = 2e-5


@pytest.fixture(autouse=True)
def no_threads_outlive_a_test():
    """Every loader a test starts has joined its decode threads when the
    test ends, so none runs on into the worker's later tests."""
    before = set(threading.enumerate())
    yield
    gc.collect()
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert not left, left


@pytest.fixture(autouse=True, scope="module")
def fp32():
    """The comparisons in fp32 (precision "highest"), whatever an earlier
    test of the worker left set; restored after the module."""
    from gan_codes_tpu_torch.utils.device import set_matmul_precision

    previous = set_matmul_precision("highest")
    yield
    set_matmul_precision(previous)


def _close(got, want, tol=TOL):
    """max|got - want| <= tol * max(|want|)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.fixture(scope="module")
def model():
    sd = {m: weights_galip.make(D, m, 5, "cpu") for m in weights_galip.LEAVES}
    clip = CLIP(CFG.text_encoder)
    clip.load_state_dict(sd["clip"])
    g, d = galip.build(CFG, clip)
    g.load_state_dict(sd["generator"])
    d.load_state_dict(sd["discriminator"])
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([
        frame_clip(rng.integers(0, 49406, n), 77, 49406, 49407)[0]
        for n in (3, 18, 40, 90)]))
    gen = torch.Generator().manual_seed(1)
    noise = torch.randn(B, 100, generator=gen)
    images = torch.rand(B, 32, 32, 3, generator=gen) * 2 - 1
    return dict(sd=sd, clip=clip, g=g, d=d, ids=ids, noise=noise,
                images=images)


def test_every_gamma_and_beta_is_live(model):
    """D's scalar gammas and betas, and each affine's second layer, are
    away from GALIP's zero init, so every branch reaches the output."""
    sd = model["sd"]["discriminator"]
    scalars = [k for k in sd if k.endswith((".gamma", ".beta"))]
    assert len(scalars) == 5 and all(float(sd[k]) >= 0.25 for k in scalars)
    g = model["sd"]["generator"]
    assert all(g[k].abs().max() > 0 for k in g if "linear2" in k)


@pytest.mark.parametrize("part", ["text", "image_local", "image_global",
                                  "generator", "net_d_c"])
def test_port_matches_the_reference(model, part):
    sd, clip, ids = model["sd"], model["clip"], model["ids"]
    with torch.no_grad():
        s = ref.encode_text(sd["clip"], ids, 2)
        if part == "text":
            got, want = clip(ids, None), s
        elif part in ("image_local", "image_global"):
            loc, glob = clip.encode_image(model["images"])
            w_loc, w_glob = ref.encode_image(
                sd["clip"], model["images"].permute(0, 3, 1, 2), 1)
            got, want = ((loc, w_loc.permute(0, 1, 3, 4, 2))
                         if part == "image_local" else (glob, w_glob))
            assert loc.shape == (B, 3, 7, 7, 32)
        elif part == "generator":  # the mapper with its prompts inside
            got = model["g"](model["noise"], s)
            want = ref.generator(sd["generator"], sd["clip"], model["noise"],
                                 s, D).permute(0, 2, 3, 1)
            assert 0.02 < float(got.std()) < 0.95
        else:
            loc = clip.encode_image(model["images"])[0]
            got = model["d"].logits(loc, s).reshape(-1)
            want = ref.net_c(sd["discriminator"], ref.net_d(
                sd["discriminator"], loc.permute(0, 1, 4, 2, 3)), s)
    assert got.shape == want.shape
    assert _close(got, want), float((got - want).abs().max())


def test_a_bfloat16_reference_fails_the_tolerance(model):
    """The reference's text tower under bfloat16 autocast lies outside
    the tolerance the fp32 port meets."""
    sd, ids = model["sd"], model["ids"]
    with torch.no_grad():
        want = ref.encode_text(sd["clip"], ids, 2)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            low = ref.encode_text(sd["clip"], ids, 2).float()
        assert _close(model["clip"](ids), want)
    assert not _close(low, want)


@pytest.mark.parametrize("which", ["d_loss", "g_loss"])
def test_losses_match_the_reference(model, which):
    """L_D (hinge with the rolled mismatch, plus the MA-GP over the CLIP
    features and the sentence) and L_G (hinge less 4 x the CLIP cosine)
    of the port against the reference's, on the same features."""
    sd, clip, d = model["sd"], model["clip"], model["d"]
    pd = sd["discriminator"]
    with torch.no_grad():
        s = clip(model["ids"])
        fake = model["g"](model["noise"], s)
        f_real = clip.encode_image(model["images"])[0]
        f_fake = clip.encode_image(fake)[0]
    if which == "d_loss":
        got, _, gp = losses.galip_d_loss(d, f_real, f_fake, s,
                                         torch.roll(s, -1, 0), 2.0, 6)
        fr = f_real.permute(0, 1, 4, 2, 3).clone().requires_grad_(True)
        sr = s.clone().requires_grad_(True)
        hr = ref.net_d(pd, fr)
        pr = ref.net_c(pd, hr, sr)
        pf = ref.net_c(pd, ref.net_d(pd, f_fake.permute(0, 1, 4, 2, 3)), s)
        pm = ref.net_c(pd, hr, torch.roll(s, -1, 0))
        gf, gs = torch.autograd.grad(pr.sum(), (fr, sr))
        norm = torch.cat([gf.reshape(B, -1), gs.reshape(B, -1)], 1).norm(
            dim=1)
        want_gp = 2.0 * (norm ** 6).mean()
        want = (F.relu(1 - pr).mean() + (F.relu(1 + pf).mean()
                                         + F.relu(1 + pm).mean()) / 2
                + want_gp)
        assert _close(gp.detach(), want_gp.detach())
    else:
        got = losses.galip_g_loss(d, clip, fake, s, 4.0, (1, 4, 8))[0]
        loc, glob = ref.encode_image(sd["clip"], fake.permute(0, 3, 1, 2), 1)
        want = (-ref.net_c(pd, ref.net_d(pd, loc), s).mean()
                - 4.0 * F.cosine_similarity(glob, s, dim=1).mean())
    assert _close(got.detach(), want.detach())


def _port_step(model, mesh=None):
    st = create_train_state(CFG, 0, device="cpu", clip=model["clip"])
    st.generator.load_state_dict(model["sd"]["generator"])
    st.g_ema.load_state_dict(model["sd"]["generator"])
    st.discriminator.load_state_dict(model["sd"]["discriminator"])
    st.rng.manual_seed(9)
    out = make_train_step(CFG, mesh)(st, model["clip"], model["images"],
                                     model["ids"], None)
    return st, out


@pytest.fixture(scope="module")
def one_step(model):
    st, out = _port_step(model)
    rs = ref.TrainState(D, model["sd"]["generator"],
                        model["sd"]["discriminator"], model["sd"]["clip"],
                        torch.Generator().manual_seed(9))
    want = ref.train_step(rs, model["images"].permute(0, 3, 1, 2),
                          model["ids"])
    return st, out, rs, want


@pytest.mark.parametrize("module", ["d", "g"])
def test_first_gradients_match_the_reference(one_step, module):
    """Each optimizer's gradient of the first step (Adam's first moment,
    beta1 = 0) against the reference's, by leaf, and the step's losses."""
    st, out, rs, want = one_step
    for k in ("d_loss", "d_gp_loss", "g_loss", "txtimg_loss"):
        assert abs(float(out[k]) - want[k]) <= 1e-5 * max(abs(want[k]),
                                                         1e-3), k
    mod, opt, ref_p, ref_opt = ((st.discriminator, st.d_opt, rs.d, rs.d_opt)
                                if module == "d" else
                                (st.generator, st.g_opt, rs.g, rs.g_opt))
    got = {n: opt.adam.state[p]["exp_avg"] for (n, _), p in
           zip(mod.named_parameters(), opt.params)}
    want_g = dict(zip(ref_p, ref_opt.first))
    assert set(got) == set(want_g)
    med = float(torch.stack([g.norm() for g in want_g.values()]).median())
    assert med > 0
    for n, w in want_g.items():
        gap = float((got[n] - w).norm())
        assert gap <= 1e-4 * max(float(w.norm()), med), (n, gap)


def test_galip_step_runs_no_penalty_conv(model):
    """GALIP's step (CLIP, G, NetD and NetC, its feature MA-GP) keeps
    `F.conv2d` and autograd's own nodes: no conv runs as DF-GAN's
    `ops_nn.PenaltyConv2d`, and no weight term is formed by one."""
    from unittest import mock

    terms = ops_nn.PenaltyConv2d.weight_terms
    with mock.patch.object(ops_nn.PenaltyConv2d, "apply",
                           wraps=ops_nn.PenaltyConv2d.apply) as forwards:
        _port_step(model)
    assert forwards.call_count == 0
    assert ops_nn.PenaltyConv2d.weight_terms == terms


def test_a_mesh_of_one_process_takes_the_same_step(model, one_step):
    """The data-parallel forms (losses over the global count, the rolled
    mismatch wrapping to rank 0's sentence) on a mesh of one process
    without a group give the plain step's update."""
    st, _, _, _ = one_step
    st1, _ = _port_step(model, Mesh(device=torch.device("cpu")))
    for (n, a), b in zip(st.generator.named_parameters(),
                         st1.generator.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("sizes", [(7, 8), (64, 224)])
def test_resize_nearest_is_interpolate(sizes):
    src, dst = sizes
    x = torch.randn(2, src, src, 3)
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(dst, dst),
                         mode="nearest").permute(0, 2, 3, 1)
    assert torch.equal(ops_nn.resize_nearest(x, dst), want)


@pytest.mark.parametrize("n", [0, 5, 75, 90])
def test_clip_framing(n):
    """Start-of-text, at most 75 ids, end-of-text, zeros to 77; the text
    tower reads the end-of-text row (the largest id)."""
    ids = np.arange(100, 100 + n)
    out, length = frame_clip(ids, 77, 49406, 49407)
    kept = min(n, 75)
    assert out.shape == (77,) and length == kept + 2
    assert out[0] == 49406 and out[kept + 1] == 49407
    assert list(out[1:kept + 1]) == list(ids[:kept])
    assert not out[kept + 2:].any()
    assert int(np.argmax(out)) == kept + 1


def test_config_round_trips_and_dispatches():
    d = dataclasses.asdict(CFG)
    assert d["architecture"] == "galip"
    assert config_from_dict(json.loads(json.dumps(d))) == CFG
    assert isinstance(config_from_dict(dataclasses.asdict(GANConfig())),
                      GANConfig)


def _trainer(tmp, clip, cfg):
    from gan_codes_tpu_torch.train.trainer import Trainer

    return Trainer(cfg, clip, str(tmp / "w"), str(tmp / "i"), seed=3,
                   device="cpu")


def test_checkpoint_resumes_a_galip_trainer_bit_for_bit(tmp_path, model):
    """Two epochs straight equal one epoch, a checkpoint, and a resumed
    second epoch in a new trainer, bit for bit (G, D + C, the EMA, Adam
    and the step's random stream)."""
    from gan_codes_tpu_torch.data import make_synthetic_cub
    from gan_codes_tpu_torch.data.dataset import CUBDataset
    from gan_codes_tpu_torch.data.loader import DataLoader

    make_synthetic_cub(str(tmp_path / "cub"), n_train=8, n_test=0,
                       image_size=40)
    cfg = dataclasses.replace(CFG, data=dataclasses.replace(
        CFG.data, data_dir=str(tmp_path / "cub"), image_size=32))

    def loader():
        return DataLoader(CUBDataset(cfg.data, "train"), B, seed=1,
                          num_threads=1)

    runs = {}
    for name, plan in (("straight", [2]), ("resumed", [1, 2])):
        for epochs in plan:
            t = _trainer(tmp_path / name, model["clip"], cfg)
            t.fit(loader(), None, num_epochs=epochs)
            t.close()
        runs[name] = t
    a, b = runs["straight"].state, runs["resumed"].state
    assert a.step == b.step == 4
    for m in ("generator", "discriminator", "g_ema"):
        for (n, x), y in zip(getattr(a, m).state_dict().items(),
                             getattr(b, m).state_dict().values()):
            assert torch.equal(x, y), (m, n)
    assert runs["resumed"].clip_tokens > 0
    with open(tmp_path / "resumed" / "w" / "config.json") as f:
        assert config_from_dict(json.load(f)) == cfg


def test_train_entry_trains_galip_from_a_config_file(tmp_path):
    from gan_codes_tpu_torch import train_entry
    from gan_codes_tpu_torch.data import make_synthetic_cub

    make_synthetic_cub(str(tmp_path / "cub"), n_train=8, n_test=4,
                       image_size=40)
    path = tmp_path / "galip.json"
    path.write_text(json.dumps(D))
    hist = train_entry.main([
        "--data", str(tmp_path / "cub"), "--config", str(path),
        "--batch-size", "4", "--epochs", "1", "--device", "cpu",
        "--images", str(tmp_path / "img"), "--weights",
        str(tmp_path / "w")])
    assert len(hist["d_losses"]) == 1 and np.isfinite(hist["d_losses"][0])
    assert {"gen_0.pth", "checkpoint", "config.json"} <= set(
        os.listdir(tmp_path / "w"))


def test_train_entry_refuses_remat_g_with_a_config(tmp_path):
    """`--remat-g` recomputes DF-GAN's blocks; with a GALIP config it is
    refused before any data is read."""
    from gan_codes_tpu_torch import train_entry

    path = tmp_path / "galip.json"
    path.write_text(json.dumps(D))
    with pytest.raises(ValueError, match="--remat-g"):
        train_entry.main([
            "--data", str(tmp_path / "missing"), "--config", str(path),
            "--remat-g", "--device", "cpu", "--images",
            str(tmp_path / "img"), "--weights", str(tmp_path / "w")])


def _dfgan_state(cfg):
    st = create_train_state(cfg, 4, device="cpu")
    for p in st.discriminator.parameters():  # live residual gammas
        if p.numel() == 1:
            p.data.fill_(0.5)
    for p in st.generator.parameters():
        if p.numel() == 1:
            p.data.fill_(0.5)
    return st


@pytest.mark.parametrize("mesh", [False, True])
def test_dfgan_step_is_unchanged_bit_for_bit(mesh):
    """DF-GAN's three-phase step after the refactor (the shared hinge and
    penalty helpers, the phases' tools, the dispatch) against the step as
    it was, two steps from the same state, plain and on a mesh of one
    process: every parameter, the EMA and the metrics, bit for bit."""
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder

    cfg = GANConfig.for_image_size(32, n_channels=8, vocab_size=30,
                                   batch_size=4)
    torch.manual_seed(0)
    te = RNNEncoder(cfg.text_encoder).eval()
    gen = torch.Generator().manual_seed(2)
    images = torch.rand(4, 32, 32, 3, generator=gen) * 2 - 1
    caps = torch.randint(2, 30, (4, 18), generator=gen)
    lens = torch.tensor([18, 5, 9, 12])
    m = Mesh(device=torch.device("cpu")) if mesh else None
    out = []
    for make in (make_train_step, torch_port_dfgan_before.make_train_step):
        st = _dfgan_state(cfg)
        step = make(cfg, m)
        metrics = [step(st, te, images, caps, lens) for _ in range(2)]
        out.append((st, metrics))
    (a, ma), (b, mb) = out
    for x, y in zip(ma, mb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for mod in ("generator", "discriminator", "g_ema"):
        for (n, x), y in zip(getattr(a, mod).state_dict().items(),
                             getattr(b, mod).state_dict().values()):
            assert torch.equal(x, y), (mod, n)

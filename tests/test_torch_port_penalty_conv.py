"""`ops/nn.py::PenaltyConv2d`, the conv of DF-GAN's MA-GP forward, against
autograd's own double backward of `F.conv2d` on the CPU: the penalty's
value and every parameter gradient, at each of D's conv forms and through
the whole D, in float64 (within 1e-12 of the largest value), float32 and
bfloat16 (within the tolerances of tests/test_torch_port_train.py::
TestLosses::test_ma_gp_value_and_d_grads_match_jax: rtol 1e-4, and an atol
of 1e-4 x the tensor's largest gradient; in bfloat16 under 1% of a
tensor's elements may instead lie one bfloat16 rounding apart). Only the
order of the weight terms' sums differs.

Also: `PenaltyConv2d.weight_terms` counts 19 weight terms a DF-GAN MA-GP
step at 256 px (one per D conv) and none elsewhere, and the conv runs in
MA-GP's forward alone: phases 1 and 3 of the step, G and the Sampler keep
`F.conv2d` with autograd's own nodes.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from gan_codes_tpu_torch import serve
from gan_codes_tpu_torch.config import (DiscriminatorConfig, GANConfig,
                                        LossConfig)
from gan_codes_tpu_torch.models.discriminator import Discriminator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.ops import nn as ops_nn
from gan_codes_tpu_torch.train import losses
from gan_codes_tpu_torch.train.state import create_train_state
from gan_codes_tpu_torch.train.step import make_train_step
from torch_port_env import one_thread_children  # noqa: E402,F401

LOSS = LossConfig()
TOL = {torch.float64: 1e-12, torch.float32: 1e-4, torch.bfloat16: 1e-4}

# D's conv forms: (Cin, Cout, kernel, stride, padding, bias, H = W)
FORMS = {
    "3x3_pad1": (3, 8, 3, 1, 1, True, 12),        # the stem; block conv 2
    "4x4_stride2_pad1": (4, 8, 4, 2, 1, False, 12),  # block conv 1
    "2x2_stride2_shortcut": (4, 8, 1, 2, 0, True, 12),  # 1x1 / 4 over 2x2
    "4x4_valid_logits": (8, 1, 4, 1, 0, False, 4),
    "3x3_joint": (8, 6, 3, 1, 1, False, 4),       # image embeds + sentence
}
SENT = 5


def _form_params(form, dtype, gen):
    cin, cout, k, _, _, bias, hw = FORMS[form]
    if form == "3x3_joint":
        cin += SENT

    def draw(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    p = {"w": draw(cout, cin, k, k, scale=(cin * k * k) ** -0.5),
         "v": draw(1, hw, hw, cout, scale=0.3)}
    if bias:
        p["b"] = draw(cout, scale=0.1)
    return p


def _form_logits(p, x, s, form, penalty):
    """The conv in D's setting: its input (for the joint conv the image
    embeds beside the tiled sentence), the conv, then a LeakyReLU and a
    weighted sum, so that the conv's output gradient depends on a
    parameter (`v`) and the double backward forms both of its terms."""
    _, _, k, stride, padding, _, _ = FORMS[form]
    if form == "3x3_joint":
        b, h, w, _ = x.shape
        x = torch.cat([x, s[:, None, None, :].expand(b, h, w, SENT)], -1)
    w = p["w"]
    if form == "2x2_stride2_shortcut":
        w = (w / 4.0).expand(-1, -1, 2, 2)
    y = ops_nn.conv2d(x, w, p.get("b"), stride=stride, padding=padding,
                      penalty=penalty)
    y = ops_nn.leaky_relu(y) * p["v"][:, :y.shape[1], :y.shape[2]].to(
        y.dtype)
    return y.sum(dim=(1, 2, 3))


def _penalty(logits, images, sents):
    """MA-GP's penalty (`losses.ma_gradient_penalty`) from the logits."""
    g_img, g_sent = torch.autograd.grad(logits.sum(), (images, sents),
                                        create_graph=True,
                                        allow_unused=True)
    if g_sent is None:
        g_sent = g_img.new_zeros(g_img.shape[0], 0)
    return losses.penalty(g_img, g_sent, LOSS.gp_coef, LOSS.gp_power,
                          LOSS.gp_eps, LOSS.gp_norm_clip)


def _discriminator(dtype):
    """A seeded 32-px D, its biases and block gammas drawn away from 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        d = Discriminator(DiscriminatorConfig(n_channels=4, image_size=32,
                                              sentence_dim=SENT))
        with torch.no_grad():
            for p in d.parameters():
                if p.ndim == 1:
                    p.copy_(torch.randn_like(p) * 0.3)
    return d.to(dtype if dtype == torch.float64 else torch.float32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("form", list(FORMS) + ["discriminator"])
def test_penalty_conv_matches_autograd_double_backward(form, dtype):
    """The penalty's value and its gradient with respect to every
    parameter (the conv's weight and bias, the head's `v`; D's every
    leaf), `PenaltyConv2d` against autograd's own double backward, from
    the same inputs: float64 within 1e-12, float32 and bfloat16 (the
    inputs in bfloat16, the parameters in float32 and cast at use, as
    `gp_compute_dtype` "bfloat16" runs D) within rtol 1e-4 and an atol of
    1e-4 x the tensor's largest gradient (bfloat16: but for under 1% of
    a tensor's elements one bfloat16 rounding apart)."""
    gen = torch.Generator().manual_seed(7)
    param_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    if form == "discriminator":
        d = _discriminator(dtype)
        params = dict(d.named_parameters())
        hw = 32
    else:
        params = {k: v.requires_grad_(True) for k, v in
                  _form_params(form, param_dtype, gen).items()}
        hw = FORMS[form][-1]
    cin = 3 if form in ("discriminator", "3x3_pad1") else FORMS[form][0]
    x0 = torch.randn(3, hw, hw, cin, generator=gen).to(dtype)
    s0 = torch.randn(3, SENT, generator=gen).to(dtype)

    out = []
    for penalty in (True, False):
        x = x0.clone().requires_grad_(True)
        s = s0.clone().requires_grad_(True)
        if form == "discriminator":
            if penalty:  # the loss itself
                gp = losses.ma_gradient_penalty(d, x0, s0, LOSS)
            else:
                gp = _penalty(d.logits(d.embeds(x), s), x, s)
        else:
            gp = _penalty(_form_logits(params, x, s, form, penalty), x, s)
        grads = torch.autograd.grad(gp, list(params.values()),
                                    allow_unused=True)
        out.append((gp, [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params.values(), grads)]))
    (gp, got), (gp_want, want) = out
    tol = TOL[dtype]
    assert gp_want.abs() > 1e-30
    np.testing.assert_allclose(gp.item(), gp_want.item(), rtol=tol)
    # a bias moves no input gradient; every weight and `v` takes a term
    assert all(float(w.abs().max()) > 0 for name, w in zip(params, want)
               if not name.endswith(("b", "bias"))), form
    for name, g, w in zip(params, got, want):
        g, w = g.double().numpy(), w.double().numpy()
        err = np.abs(g - w)
        close = err <= tol * np.abs(w) + tol * np.abs(w).max() + 1e-300
        if dtype == torch.bfloat16:
            # A weight term whose two fp32 sums lie either side of a
            # bfloat16 rounding boundary rounds one bfloat16 ulp apart (2^-8
            # of its value, past any tolerance finer than bfloat16 itself):
            # allowed on under 1% of a tensor's elements, the rest held as
            # in float32.
            top = np.maximum(np.abs(g), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0))) - 7)
            assert np.all(close | (err <= ulp)), name
            assert (~close).mean() < 0.01, (name, int((~close).sum()))
        else:
            assert close.all(), (name, float(err.max()),
                                 float(np.abs(w).max()))


def _dfgan_256(gp_interval):
    cfg = GANConfig.for_image_size(256, n_channels=2, vocab_size=30,
                                   batch_size=2)
    return dataclasses.replace(cfg, loss=dataclasses.replace(
        cfg.loss, gp_interval=gp_interval))


def test_weight_terms_count_the_penalty_convs_alone():
    """At 256 px D has 19 convs (the stem, 6 blocks x 2, 4 shortcuts, the
    2 logits convs). A step with the penalty forms 19 weight terms and
    runs 19 `PenaltyConv2d` forwards, all of them MA-GP's (phase 1 and
    phase 3 run 38 D convs more, on `F.conv2d`); a `gp_interval` 2 step
    without the penalty forms and runs none, nor does a Sampler call."""
    cfg = _dfgan_256(2)
    st = create_train_state(cfg, 4, device="cpu")
    assert sum(isinstance(m, torch.nn.Conv2d)
               for m in st.discriminator.modules()) == 19
    torch.manual_seed(0)
    te = RNNEncoder(cfg.text_encoder).eval()
    gen = torch.Generator().manual_seed(2)
    images = torch.rand(2, 256, 256, 3, generator=gen) * 2 - 1
    caps = torch.randint(2, 30, (2, 18), generator=gen)
    lens = torch.tensor([18, 5])
    step = make_train_step(cfg)
    counts = []
    with mock.patch.object(ops_nn.PenaltyConv2d, "apply",
                           wraps=ops_nn.PenaltyConv2d.apply) as forwards:
        for _ in range(2):
            ops_nn.PenaltyConv2d.weight_terms = forwards.call_count = 0
            metrics = step(st, te, images, caps, lens)
            counts.append((float(metrics["d_gp_active"]),
                           ops_nn.PenaltyConv2d.weight_terms,
                           forwards.call_count))
        ops_nn.PenaltyConv2d.weight_terms = forwards.call_count = 0
        sampler = serve.Sampler(cfg, st.generator, te, batch_size=2,
                                device="cpu")
        sampler.generate_tokens(caps.numpy(), lens.numpy())
        counts.append((ops_nn.PenaltyConv2d.weight_terms,
                       forwards.call_count))
    assert counts == [(1.0, 19, 19), (0.0, 0, 0), (0, 0)]

"""The port in bfloat16 held against the JAX package in bfloat16: a G
forward, D's embeds and logits, and one `make_train_step`, from the same
numpy inputs with the weights carried across by `models/torch_import.py`.

Both sides round every op to bf16, and the LeakyReLU slope is 0.2 rounded
to bf16 on both (JAX's weak-typed scalar; `ops/nn.py::neg_slope`): with
the slope multiplied in fp32 and rounded, each of these tests fails.

One other bf16 difference is kept out of the first G test: the port's
`dense` adds the bias inside `F.linear`'s one rounding, where JAX rounds
x @ w and then adds b (ROADMAP Queue 3). G's `linear_in` bias is 0 there,
and a second case with its bias holds G within a bf16 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_codes_tpu import config as jcfg
from gan_codes_tpu.models import discriminator as jdisc
from gan_codes_tpu.models import generator as jgen
from gan_codes_tpu.models.text_encoder import init_text_encoder
from gan_codes_tpu.train import state as jstate
from gan_codes_tpu.train.step import _cast
from gan_codes_tpu.train.step import make_train_step as jax_make_train_step
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.models.discriminator import Discriminator
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.train import state as pstate
from gan_codes_tpu_torch.train.step import make_train_step

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _f32(a) -> np.ndarray:
    return np.array(a.detach().float() if isinstance(a, torch.Tensor)
                    else a, np.float32)


def _gammas(blocks, base):
    """Every block gamma away from its 0 init."""
    for i, bp in enumerate(blocks):
        bp["gamma"] = jnp.asarray(base + 0.07 * i, jnp.float32)


class TestGenerator:
    CFG = jcfg.GeneratorConfig(n_channels=8, image_size=32, sentence_dim=16,
                               affine_hidden=24)

    def _run(self, zero_bias: bool):
        params = jgen.init_generator(jax.random.PRNGKey(5), self.CFG)
        _gammas(params["blocks"], 0.3)
        if zero_bias:
            params["linear_in"]["b"] = jnp.zeros_like(
                params["linear_in"]["b"])
        rng = np.random.default_rng(0)
        noise = rng.standard_normal((4, self.CFG.latent_dim)).astype(
            np.float32)
        sent = rng.standard_normal((4, 16)).astype(np.float32)
        g = Generator(pcfg.GeneratorConfig(**dataclasses.asdict(self.CFG)))
        g.load_state_dict(pimport.generator_state_dict_from_jax(
            _np_tree(params)), strict=True)
        with torch.no_grad():
            got = g.eval()(T(noise).bfloat16(), T(sent).bfloat16())
        assert got.dtype == torch.bfloat16
        want = jgen.generator_apply(
            _cast(params, jnp.bfloat16),
            dataclasses.replace(self.CFG, use_pallas=False),
            jnp.asarray(noise).astype(jnp.bfloat16),
            jnp.asarray(sent).astype(jnp.bfloat16))
        return _f32(got), _f32(want)

    def test_forward_equals_jax_but_for_rare_conv_roundings(self):
        """32px, n_channels 8, linear_in's bias 0: at most 1% of the output
        values differ, each by at most 2^-7 max|ref| (the convs sum in
        other orders, which flips a bf16 rounding now and then: 1 value of
        12,288 here; with the parent's slope about half differed)."""
        got, want = self._run(zero_bias=True)
        differ = got != want
        assert differ.mean() <= 0.01
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()

    def test_forward_with_the_dense_bias_within_bf16(self):
        """With linear_in's bias: max|err| <= 2^-5 max|ref| (the dense
        layer's bias rounding moves values by an ulp)."""
        got, want = self._run(zero_bias=False)
        assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()


def test_discriminator_embeds_and_logits_equal_jax_bit_for_bit():
    """32px, n_channels 4, every gamma != 0: embeds and logits bit for bit
    (the parent's slope differed in 6% of the embeds)."""
    cfg = jcfg.DiscriminatorConfig(n_channels=4, image_size=32,
                                   sentence_dim=10)
    params = jdisc.init_discriminator(jax.random.PRNGKey(1), cfg)
    _gammas(params["blocks"], 0.25)
    d = Discriminator(pcfg.DiscriminatorConfig(**dataclasses.asdict(cfg)))
    d.load_state_dict(pimport.discriminator_state_dict_from_jax(
        _np_tree(params)), strict=True)
    rng = np.random.default_rng(2)
    real = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    sents = rng.standard_normal((6, 10)).astype(np.float32)
    pb = _cast(params, jnp.bfloat16)
    want_e = jdisc.discriminator_embeds(
        pb, jnp.asarray(real).astype(jnp.bfloat16))
    want_l = jdisc.discriminator_logits(
        pb, want_e, jnp.asarray(sents).astype(jnp.bfloat16))
    with torch.no_grad():
        e = d.embeds(T(real).bfloat16())
        logits = d.logits(e, T(sents).bfloat16())
    np.testing.assert_array_equal(_f32(e), _f32(want_e))
    np.testing.assert_array_equal(_f32(logits), _f32(want_l))


def test_one_train_step_matches_jax():
    """One bf16 `make_train_step` (16px, G n_channels 16, D n_channels 4,
    batch 6, gp_interval 1, linear_in's bias 0) from the same weights,
    batch and noise: the losses within rtol 2e-2 (the GP and the losses
    sum in other orders), and D's parameters after the step within a mean
    |difference| of 2e-6 of the JAX step's (the step moves them by about
    1e-4; with the parent's slope the mean was 4.9e-6, with this one
    7.5e-7)."""
    jc = jcfg.GANConfig(
        generator=jcfg.GeneratorConfig(n_channels=16, image_size=16),
        discriminator=jcfg.DiscriminatorConfig(n_channels=4, image_size=16),
        text_encoder=jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                            hidden_dim=256, max_len=6),
        train=jcfg.TrainConfig(batch_size=6, compute_dtype="bfloat16"))
    pc = pcfg.GANConfig.from_dict(dataclasses.asdict(jc))
    jst = jstate.create_train_state(jax.random.PRNGKey(77), jc)
    _gammas(jst.g_params["blocks"], 0.30)
    _gammas(jst.d_params["blocks"], 0.25)
    jst.g_params["linear_in"]["b"] = jnp.zeros_like(
        jst.g_params["linear_in"]["b"])
    te = init_text_encoder(jax.random.PRNGKey(3), jc.text_encoder)
    pst = pstate.create_train_state(pc, seed=0, device="cpu")
    pst.generator.load_state_dict(pimport.generator_state_dict_from_jax(
        _np_tree(jst.g_params)), strict=True)
    pst.discriminator.load_state_dict(
        pimport.discriminator_state_dict_from_jax(_np_tree(jst.d_params)),
        strict=True)
    pte = RNNEncoder(pc.text_encoder).eval()
    pte.load_state_dict(pimport.text_encoder_state_dict_from_jax(
        _np_tree(te)), strict=True)

    ki, kc, kl = jax.random.split(jax.random.PRNGKey(9), 3)
    images = jax.random.normal(ki, (6, 16, 16, 3)) * 0.5
    caps = jax.random.randint(kc, (6, 6), 1, 30)
    lens = jax.random.randint(kl, (6,), 2, 7)
    _, k_noise, _, _, _ = jax.random.split(jst.rng, 5)
    noise = jax.random.normal(k_noise, (6, 100))
    jst, jm = jax.jit(jax_make_train_step(jc))(jst, te, images, caps, lens)
    pm = make_train_step(pc)(pst, pte, T(np.asarray(images)),
                             T(np.asarray(caps)), T(np.asarray(lens)),
                             noise=T(np.asarray(noise)))
    for k in ("d_loss", "d_gp_loss", "g_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-2,
                                   err_msg=k)
    want = pimport.discriminator_state_dict_from_jax(_np_tree(jst.d_params))
    got = pst.discriminator.state_dict()
    total = sum(float((got[k].float() - want[k].float()).abs().sum())
                for k in want)
    assert total / sum(want[k].numel() for k in want) <= 2e-6

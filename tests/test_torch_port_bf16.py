"""The port in bfloat16 held against the JAX package in bfloat16: a G
forward, D's embeds and logits, and one `make_train_step`, from the same
numpy inputs with the weights carried across by `models/torch_import.py`.

Both sides round every op to bf16, and the LeakyReLU slope is 0.2 rounded
to bf16 on both (JAX's weak-typed scalar; `ops/nn.py::neg_slope`): with
the slope multiplied in fp32 and rounded, each of these tests fails.

`dense` rounds x @ w to bf16 and then adds the bias, as JAX's `nn.dense`
does (with the bias inside `F.linear`'s one rounding, the dense test and
the G case with `linear_in`'s bias fail).
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
from gan_codes_tpu.ops import nn as jnn
from gan_codes_tpu.train import state as jstate
from gan_codes_tpu.train.step import _cast
from gan_codes_tpu.train.step import make_train_step as jax_make_train_step
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.models.discriminator import Discriminator
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.ops import nn as pnn
from gan_codes_tpu_torch.train import state as pstate
from gan_codes_tpu_torch.train.step import make_train_step
from torch_port_env import one_thread_children  # noqa: E402,F401

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
        """With linear_in's bias: the same bound as the zero-bias case
        (with the bias inside `F.linear`'s rounding about half of the
        output values differed)."""
        got, want = self._run(zero_bias=False)
        differ = got != want
        assert differ.mean() <= 0.01
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(4, 100, 128), (6, 24, 64)])
def test_dense_equals_jax_bit_for_bit(shape):
    """bf16 `dense` with a bias equals JAX's `nn.dense` bit for bit: x @ w
    rounded to bf16, then the bias added in bf16 (F.linear(x, w, b), which
    adds it inside the product's rounding, differs at these shapes)."""
    b, n_in, n_out = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    w = (rng.standard_normal((n_in, n_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((n_out,)).astype(np.float32)
    want = jnn.dense({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                     jnp.asarray(x).astype(jnp.bfloat16))
    got = pnn.dense(T(x).bfloat16(), T(np.ascontiguousarray(w.T)), T(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


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
    batch 6, gp_interval 1) from the same weights,
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


def test_gradients_after_an_inference_mode_call():
    """`dense` and a bf16 `leaky_relu` called first under
    torch.inference_mode (as a Sampler calls them) still backpropagate
    afterwards in the same process: their cached constants (`dense`'s
    zero bias, the bf16 slope) are made outside inference mode. Gradients
    equal those of x @ w.T + b and of the jnp-style where."""
    rng = np.random.default_rng(3)
    x = T(rng.standard_normal((5, 7)).astype(np.float32))
    w = T(rng.standard_normal((9, 7)).astype(np.float32)).requires_grad_()
    b = T(rng.standard_normal((9,)).astype(np.float32)).requires_grad_()
    h = T(rng.standard_normal((4, 9)).astype(np.float32)).bfloat16()
    pnn.neg_slope.cache_clear()
    pnn._zeros.cache_clear()
    with torch.inference_mode():
        pnn.dense(x, w.detach(), b.detach())
        pnn.leaky_relu(h)
    (pnn.dense(x, w, b) ** 2).sum().backward()
    w2, b2 = w.detach().clone().requires_grad_(), b.detach().clone(
    ).requires_grad_()
    ((x @ w2.T + b2) ** 2).sum().backward()
    torch.testing.assert_close(w.grad, w2.grad)
    torch.testing.assert_close(b.grad, b2.grad)
    h.requires_grad_()
    pnn.leaky_relu(h).float().sum().backward()
    want = torch.where(h.detach() >= 0, 1.0, 0.2).bfloat16()
    assert torch.equal(h.grad, want)

"""The port's config, ops, generator, text encoder and weight carry-across
held against the JAX package, on the same numpy-made inputs and weights.

JAX runs on the CPU at highest matmul precision (tests/conftest.py), and its
Pallas kernels in interpret mode; the port runs its kernels' plain versions
(CPU tensors)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_codes_tpu import config as jcfg
from gan_codes_tpu.models import generator as jgen
from gan_codes_tpu.models import text_encoder as jte
from gan_codes_tpu.models import torch_import as jimport
from gan_codes_tpu.ops import blocks as jblocks
from gan_codes_tpu.ops import fusion as jfusion
from gan_codes_tpu.ops import nn as jnn
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.ops import blocks as pblocks
from gan_codes_tpu_torch.ops import fusion as pfusion
from gan_codes_tpu_torch.ops import nn as pnn


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _with_gammas(params, seed=0):
    """Every block gamma away from its 0 init (else the residual bodies,
    and so the kernels, contribute nothing)."""
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        bp["gamma"] = jnp.asarray(rng.uniform(0.3, 0.9), jnp.float32)
    return params


def _port_generator(params, cfg) -> Generator:
    g = Generator(pcfg.GeneratorConfig(**dataclasses.asdict(cfg)))
    g.load_state_dict(pimport.generator_state_dict_from_jax(_np_tree(params)),
                      strict=True)
    return g.eval()


class TestConfig:
    @pytest.mark.parametrize("size", [None, 32, 64, 256])
    def test_asdict_matches_jax(self, size):
        if size is None:
            j, p = jcfg.GANConfig(), pcfg.GANConfig()
        else:
            j = jcfg.GANConfig.for_image_size(size, n_channels=8,
                                              vocab_size=99)
            p = pcfg.GANConfig.for_image_size(size, n_channels=8,
                                              vocab_size=99)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.generator.block_channels == j.generator.block_channels
        assert (p.discriminator.block_channels
                == j.discriminator.block_channels)

    def test_reads_jax_config_json(self):
        j = jcfg.GANConfig.for_image_size(
            64, generator_overrides={"use_pallas": True, "lane_pad": 128},
            xla_scoped_vmem_kib=65536, compute_dtype="bfloat16")
        d = dataclasses.asdict(j)
        d["generator"]["a_future_field"] = 1  # unknown keys are ignored
        p = pcfg.GANConfig.from_dict(d)
        del d["generator"]["a_future_field"]
        assert dataclasses.asdict(p) == d
        assert p.train.compute_torch_dtype == torch.bfloat16


class TestOps:
    @pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (1, 0, 1),
                                                  (2, 1, 4)])
    def test_conv2d(self, stride, padding, k):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
        w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
        b = rng.standard_normal((7,)).astype(np.float32)
        want = jnn.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), stride=stride, padding=padding)
        got = pnn.conv2d(torch.from_numpy(x),
                         torch.from_numpy(w).permute(3, 2, 0, 1),
                         torch.from_numpy(b), stride=stride, padding=padding)
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)

    def test_upsample_dense_leaky_modulate(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            pnn.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
            np.asarray(jnn.upsample_nearest_2x(jnp.asarray(x))))
        np.testing.assert_array_equal(
            pnn.leaky_relu(torch.from_numpy(x)).numpy(),
            np.asarray(jnn.leaky_relu(jnp.asarray(x))))
        w = rng.standard_normal((4, 6)).astype(np.float32)
        b = rng.standard_normal((6,)).astype(np.float32)
        np.testing.assert_allclose(
            pnn.dense(torch.from_numpy(x), torch.from_numpy(w.T),
                      torch.from_numpy(b)).numpy(),
            np.asarray(jnn.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x))), atol=1e-5, rtol=1e-5)
        g, beta = (rng.standard_normal((2, 4)).astype(np.float32)
                   for _ in range(2))
        np.testing.assert_array_equal(
            pfusion.modulate(*map(torch.from_numpy, (x, g, beta))).numpy(),
            np.asarray(jfusion.modulate(*map(jnp.asarray, (x, g, beta)))))


class TestResBlockG:
    @pytest.mark.parametrize("cin,cout", [(16, 8), (8, 8)])
    def test_matches_jax(self, cin, cout):
        """With and without the 1x1 shortcut, gamma 0.5, against the JAX
        block on its kernel path (Pallas in interpret mode)."""
        p = jblocks.init_res_block_g(jax.random.PRNGKey(3), cin, cout,
                                     sentence_dim=12, affine_hidden=24)
        p["gamma"] = jnp.asarray(0.5, jnp.float32)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
        s = rng.standard_normal((2, 12)).astype(np.float32)
        want = jblocks.res_block_g(p, jnp.asarray(x), jnp.asarray(s),
                                   use_pallas=True)
        # carry the one block across through the generator mapping
        tree = {"linear_in": {"w": np.zeros((1, 1), np.float32)},
                "blocks": [_np_tree(p)],
                "conv_out": {"w": np.zeros((3, 3, 1, 1), np.float32)}}
        sd = {k[len("res_block_out."):]: v for k, v in
              pimport.generator_state_dict_from_jax(tree).items()
              if k.startswith("res_block_out.")}
        block = pblocks.ResidualBlockG(cin, cout, sentence_dim=12,
                                       affine_hidden=24)
        block.load_state_dict(sd, strict=True)
        assert (block.scale_conv is None) == (cin == cout)
        with torch.no_grad():
            got = block(torch.from_numpy(x), torch.from_numpy(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


class TestGenerator:
    @pytest.mark.parametrize("n_channels", [4, 8])
    def test_matches_generator_apply_both_paths(self, n_channels):
        """32px, every gamma != 0, against `generator_apply` on its kernel
        path (use_pallas, interpret) and on its default path
        (fuse_upsample). atol/rtol 1e-4: conv sums reordered."""
        cfg = jcfg.GeneratorConfig(n_channels=n_channels, image_size=32,
                                   sentence_dim=16, affine_hidden=24)
        params = _with_gammas(jgen.init_generator(jax.random.PRNGKey(5),
                                                  cfg), seed=n_channels)
        rng = np.random.default_rng(6)
        noise = rng.standard_normal((2, cfg.latent_dim)).astype(np.float32)
        sent = rng.standard_normal((2, 16)).astype(np.float32)
        with torch.no_grad():
            got = _port_generator(params, cfg)(
                torch.from_numpy(noise), torch.from_numpy(sent)).numpy()
        assert got.shape == (2, 32, 32, 3)
        for use_pallas in (True, False):
            want = jgen.generator_apply(
                params, dataclasses.replace(cfg, use_pallas=use_pallas),
                jnp.asarray(noise), jnp.asarray(sent))
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                       rtol=1e-4)

    def test_param_count_and_ladder_at_256(self):
        cfg = jcfg.GeneratorConfig()
        shapes = jax.eval_shape(lambda k: jgen.init_generator(k, cfg),
                                jax.random.PRNGKey(0))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        g = Generator(pcfg.GeneratorConfig())
        assert sum(p.numel() for p in g.parameters()) == n_jax
        assert len(g.res_blocks) == 6


class TestTextEncoder:
    def test_matches_text_encoder_apply(self):
        """cap_lens 1..18 in one unsorted batch; atol 1e-5."""
        cfg = jcfg.TextEncoderConfig(vocab_size=50, embed_dim=12,
                                     hidden_dim=16)
        params = jte.init_text_encoder(jax.random.PRNGKey(7), cfg)
        rng = np.random.default_rng(8)
        lens = rng.permutation(np.arange(1, 19)).astype(np.int32)
        caps = rng.integers(1, 50, (18, 18)).astype(np.int32)
        caps[np.arange(18)[None, :] >= lens[:, None]] = 0
        want = jte.text_encoder_apply(params, cfg, jnp.asarray(caps),
                                      jnp.asarray(lens))
        te = RNNEncoder(pcfg.TextEncoderConfig(**dataclasses.asdict(cfg)))
        te.load_state_dict(
            pimport.text_encoder_state_dict_from_jax(_np_tree(params)),
            strict=True)
        with torch.no_grad():
            got = te(torch.from_numpy(caps), torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_state_dict_round_trips_through_jax_converter(self):
        cfg = jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                     hidden_dim=12)
        params = _np_tree(jte.init_text_encoder(jax.random.PRNGKey(9), cfg))
        sd = pimport.text_encoder_state_dict_from_jax(params)
        assert list(sd) == list(RNNEncoder(pcfg.TextEncoderConfig(
            **dataclasses.asdict(cfg))).state_dict())
        back = _np_tree(jte.convert_torch_state_dict(sd, cfg))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        assert dataclasses.asdict(pimport.infer_text_encoder_config(sd)) == \
            dataclasses.asdict(pcfg.TextEncoderConfig(
                **dataclasses.asdict(cfg)))


class TestWeightCarry:
    def test_generator_state_dict_equals_jax_export(self):
        cfg = jcfg.GeneratorConfig(n_channels=4, image_size=32,
                                   sentence_dim=16)
        params = _with_gammas(jgen.init_generator(jax.random.PRNGKey(10),
                                                  cfg))
        want = jimport.export_generator_state_dict(params)
        got = pimport.generator_state_dict_from_jax(_np_tree(params))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k

    def test_reference_gen_pth_loads_and_infers_like_jax(self, tmp_path):
        cfg = jcfg.GeneratorConfig(n_channels=4, image_size=32,
                                   sentence_dim=16, affine_hidden=20)
        params = jgen.init_generator(jax.random.PRNGKey(11), cfg)
        sd = jimport.export_generator_state_dict(params)
        path = str(tmp_path / "gen_3.pth")
        torch.save(sd, path)
        g, got_cfg = pimport.load_generator(path)
        assert dataclasses.asdict(got_cfg) == dataclasses.asdict(
            jimport.infer_generator_config(sd))
        assert set(g.state_dict()) == set(sd)
        # a full checkpoint.pt dict unwraps to its generator entry
        torch.save({"generator": sd, "epoch": 3}, str(tmp_path / "ck.pt"))
        g2, _ = pimport.load_generator(str(tmp_path / "ck.pt"))
        for k, v in g2.state_dict().items():
            assert torch.equal(v, sd[k])

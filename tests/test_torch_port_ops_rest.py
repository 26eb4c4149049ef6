"""The rest of the port's ops held against the JAX package: the inits, the
sub-pixel conv, the pool and the normalize of `ops/nn.py`, and
`ops/blocks.py::res_block_g_up` with its gradients, then a 32px generator
in the JAX default order (block 0, then `res_block_g_up`) against
`generator_apply` with `use_pallas=False` and `fuse_upsample=True`.

The same numpy-made inputs go to both packages; weights are carried over
by `models/torch_import.py`. JAX runs on the CPU at highest matmul
precision (tests/conftest.py); the port runs its kernels' plain versions
(CPU tensors). The inits cannot share JAX's PRNG stream, so they are held
to the distributions: shapes, layouts, bounds, moments, zero biases and
repeatability."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gan_codes_tpu import config as jcfg
from gan_codes_tpu.models import generator as jgen
from gan_codes_tpu.ops import blocks as jblocks
from gan_codes_tpu.ops import nn as jnn
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.ops import blocks as pblocks
from gan_codes_tpu_torch.ops import nn as pnn
from torch_port_env import one_thread_children  # noqa: E402,F401

SDIM, HIDDEN = 12, 24


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _block_sd(p) -> dict:
    """One JAX block tree (params or gradients) as the port block's
    state_dict, through the generator mapping (as `res_block_out`)."""
    tree = {"linear_in": {"w": np.zeros((1, 1), np.float32)},
            "blocks": [_np_tree(p)],
            "conv_out": {"w": np.zeros((3, 3, 1, 1), np.float32)}}
    return {k[len("res_block_out."):]: v for k, v in
            pimport.generator_state_dict_from_jax(tree).items()
            if k.startswith("res_block_out.")}


def _block_case(cin, cout, seed):
    """A JAX block with gamma 0.5, its port twin, and seeded inputs."""
    p = jblocks.init_res_block_g(jax.random.PRNGKey(seed), cin, cout,
                                 sentence_dim=SDIM, affine_hidden=HIDDEN)
    p["gamma"] = jnp.asarray(0.5, jnp.float32)
    block = pblocks.ResidualBlockG(cin, cout, SDIM, HIDDEN)
    block.load_state_dict(_block_sd(p), strict=True)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    s = rng.standard_normal((2, SDIM)).astype(np.float32)
    return p, block, x, s


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

# (port init, its JAX counterpart, args, weight std, weight bound or None
# for a normal draw, whether the bias is drawn)
IN, OUT = 256, 1024
INITS = {
    "linear": (pnn.torch_linear_init, jnn.torch_linear_init, (IN, OUT),
               (OUT, IN), (IN, OUT), math.sqrt(1 / IN), True),
    "xavier": (pnn.xavier_normal_linear_init, jnn.xavier_normal_linear_init,
               (IN, OUT), (OUT, IN), (IN, OUT), None, False),
    "conv": (pnn.torch_conv_init, jnn.torch_conv_init, (3, 3, 32, 96),
             (96, 32, 3, 3), (3, 3, 32, 96), math.sqrt(1 / (9 * 32)), True),
}


class TestInits:
    @pytest.mark.parametrize("kind", sorted(INITS))
    def test_shapes_and_layouts(self, kind):
        """Torch's layouts (Linear [out, in], Conv2d OIHW): the dicts load
        into the torch module strictly, and transpose to the JAX init's
        shapes."""
        init, jinit, args, shape, jshape, _, _ = INITS[kind]
        p = init(torch.Generator().manual_seed(0), *args)
        jp = jinit(jax.random.PRNGKey(0), *args)
        assert p["weight"].shape == shape and p["weight"].dtype == \
            torch.float32
        assert tuple(jp["w"].shape) == jshape
        assert p["bias"].shape == (shape[0],) == tuple(jp["b"].shape)
        module = (nn.Conv2d(*args[2:], args[0]) if kind == "conv"
                  else nn.Linear(*args))
        module.load_state_dict(p, strict=True)
        no_bias = init(torch.Generator().manual_seed(0), *args, bias=False) \
            if kind != "xavier" else None
        assert no_bias is None or set(no_bias) == {"weight"}

    @pytest.mark.parametrize("kind", sorted(INITS))
    def test_bounds_and_moments(self, kind):
        """Within the bound, the variance of the draw within 5% of the
        distribution's (and of the JAX draw's), the mean within 5% of a
        standard deviation; a zero bias where JAX has one."""
        init, jinit, args, _, _, bound, drawn_bias = INITS[kind]
        p = init(torch.Generator().manual_seed(1), *args)
        jp = jinit(jax.random.PRNGKey(1), *args)
        w = p["weight"].double().numpy()
        jw = np.asarray(jp["w"], np.float64)
        if bound is None:   # xavier normal
            std = math.sqrt(2.0 / sum(args))
        else:
            std = bound / math.sqrt(3.0)
            assert np.abs(w).max() <= bound
            assert np.abs(np.asarray(p["bias"])).max() <= bound
        for draw in (w, jw):
            assert abs(draw.var() / std ** 2 - 1) < 0.05
            assert abs(draw.mean()) < 0.05 * std
        if drawn_bias:
            assert p["bias"].abs().max() > 0
        else:
            assert not p["bias"].any() and not np.asarray(jp["b"]).any()

    @pytest.mark.parametrize("kind", sorted(INITS))
    def test_repeatable_from_one_seed(self, kind):
        init, _, args, _, _, _, _ = INITS[kind]
        a = init(torch.Generator().manual_seed(7), *args)
        b = init(torch.Generator().manual_seed(7), *args)
        c = init(torch.Generator().manual_seed(8), *args)
        for k in a:
            assert torch.equal(a[k], b[k])
        assert not torch.equal(a["weight"], c["weight"])


# ---------------------------------------------------------------------------
# the sub-pixel conv, the pool, the normalize
# ---------------------------------------------------------------------------

class TestOpsRest:
    @pytest.mark.parametrize("h,w,ci,co", [(4, 4, 3, 5), (8, 6, 16, 32),
                                           (5, 7, 4, 4)])
    def test_conv3x3_on_upsampled_matches_jax(self, h, w, ci, co):
        """Against the JAX function (atol 1e-5) and the port's own
        conv2d(upsample_nearest_2x(x)), at tests/test_parity.py's shapes."""
        rng = np.random.default_rng(h * 31 + w)
        x = rng.standard_normal((2, h, w, ci)).astype(np.float32)
        wt = (rng.standard_normal((3, 3, ci, co)) / math.sqrt(9 * ci)
              ).astype(np.float32)
        b = rng.standard_normal((co,)).astype(np.float32)
        want = jnn.conv3x3_on_upsampled(
            {"w": jnp.asarray(wt), "b": jnp.asarray(b)}, jnp.asarray(x))
        w_oihw = torch.from_numpy(wt).permute(3, 2, 0, 1)
        got = pnn.conv3x3_on_upsampled(torch.from_numpy(x), w_oihw,
                                       torch.from_numpy(b))
        assert got.shape == (2, 2 * h, 2 * w, co)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        plain = pnn.conv2d(pnn.upsample_nearest_2x(torch.from_numpy(x)),
                           w_oihw, torch.from_numpy(b), padding=1)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)

    def test_global_mean_pool_matches_jax(self):
        x = np.random.default_rng(3).standard_normal(
            (3, 5, 7, 6)).astype(np.float32)
        got = pnn.global_mean_pool(torch.from_numpy(x))
        assert got.shape == (3, 6)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnn.global_mean_pool(jnp.asarray(x))),
            atol=1e-6)

    @pytest.mark.parametrize("axis", [-1, 0])
    def test_l2_normalize_matches_jax(self, axis):
        """A zero row and a row far below eps keep x / eps, as
        F.normalize does."""
        x = np.random.default_rng(4).standard_normal((4, 6)).astype(
            np.float32)
        x[1] = 0.0
        x[2] = 1e-14
        if axis == 0:
            x = np.ascontiguousarray(x.T)
        got = pnn.l2_normalize(torch.from_numpy(x), axis)
        want = jnn.l2_normalize(jnp.asarray(x), axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        torch.testing.assert_close(
            got, torch.nn.functional.normalize(torch.from_numpy(x), dim=axis),
            rtol=0, atol=0)
        zero = got[1] if axis == -1 else got[:, 1]
        assert not zero.any()


# ---------------------------------------------------------------------------
# res_block_g_up and the generator in the JAX default order
# ---------------------------------------------------------------------------

class TestResBlockGUp:
    @pytest.mark.parametrize("cin,cout", [(16, 16), (32, 16)])
    def test_forward_matches_jax(self, cin, cout):
        """Against the JAX `res_block_g_up` (atol 1e-5) and the port's own
        res_block_g(upsample_nearest_2x(x)) (atol 1e-6)."""
        p, block, x, s = _block_case(cin, cout, seed=cin)
        assert (block.scale_conv is None) == (cin == cout)
        want = jblocks.res_block_g_up(p, jnp.asarray(x), jnp.asarray(s))
        xt, st = torch.from_numpy(x), torch.from_numpy(s)
        with torch.no_grad():
            got = pblocks.res_block_g_up(block, xt, st)
            plain = pblocks.res_block_g(block, pnn.upsample_nearest_2x(xt),
                                        st)
        assert got.shape == (2, 12, 12, cout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)

    @pytest.mark.parametrize("cin,cout", [(16, 16), (32, 16)])
    def test_gradients_match_jax(self, cin, cout):
        """d/dx, d/dsentence and d/dparameter of sum(out * ct) against
        jax.grad, through the kernels' autograd Functions (their plain
        versions here); atol/rtol 1e-4."""
        p, block, x, s = _block_case(cin, cout, seed=cin + 1)
        ct = np.random.default_rng(9).standard_normal(
            (2, 12, 12, cout)).astype(np.float32)

        def loss(params, xx, ss):
            return jnp.sum(jblocks.res_block_g_up(params, xx, ss) * ct)

        gp, gx, gs = jax.grad(loss, argnums=(0, 1, 2))(
            p, jnp.asarray(x), jnp.asarray(s))
        xt = torch.from_numpy(x).requires_grad_()
        st = torch.from_numpy(s).requires_grad_()
        out = pblocks.res_block_g_up(block, xt, st)
        (out * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs),
                                   atol=1e-4, rtol=1e-4)
        want = _block_sd(gp)
        got = dict(block.named_parameters())
        assert set(got) == set(want)
        for name, param in got.items():
            np.testing.assert_allclose(param.grad.numpy(),
                                       want[name].numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=name)

    @pytest.mark.parametrize("n_channels", [4, 8])
    def test_generator_in_the_jax_default_order(self, n_channels):
        """A 32px generator of the port's blocks run as the JAX package's
        default path runs it (block 0, then `res_block_g_up` for every
        later block), every gamma != 0, against `generator_apply` with
        use_pallas=False and fuse_upsample=True; atol/rtol 1e-4."""
        cfg = jcfg.GeneratorConfig(n_channels=n_channels, image_size=32,
                                   sentence_dim=16, affine_hidden=24)
        assert cfg.fuse_upsample and not cfg.use_pallas
        params = jgen.init_generator(jax.random.PRNGKey(5), cfg)
        rng = np.random.default_rng(n_channels)
        for bp in params["blocks"]:
            bp["gamma"] = jnp.asarray(rng.uniform(0.3, 0.9), jnp.float32)
        noise = rng.standard_normal((2, cfg.latent_dim)).astype(np.float32)
        sent = rng.standard_normal((2, 16)).astype(np.float32)
        want = jgen.generator_apply(params, cfg, jnp.asarray(noise),
                                    jnp.asarray(sent))

        g = Generator(pcfg.GeneratorConfig(**dataclasses.asdict(cfg)))
        g.load_state_dict(
            pimport.generator_state_dict_from_jax(_np_tree(params)),
            strict=True)
        st = torch.from_numpy(sent)
        with torch.no_grad():
            x = pnn.dense(torch.from_numpy(noise), g.linear_in.weight,
                          g.linear_in.bias)
            x = x.view(2, cfg.seed_channels, cfg.base_size, cfg.base_size)
            x = x.permute(0, 2, 3, 1).contiguous()
            blocks = list(g.res_blocks) + [g.res_block_out]
            x = pblocks.res_block_g(blocks[0], x, st)
            for block in blocks[1:]:
                x = pblocks.res_block_g_up(block, x, st)
            conv = g.conv_out[1]
            got = torch.tanh(pnn.conv2d(pnn.leaky_relu(x), conv.weight,
                                        conv.bias, padding=1))
            kernel_path = g(torch.from_numpy(noise), st)
        assert got.shape == (2, 32, 32, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), kernel_path.numpy(),
                                   atol=1e-5)

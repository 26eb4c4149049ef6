"""Generator and discriminator residual blocks (the port of
`gan_codes_tpu/ops/blocks.py`).

`ResidualBlockG` holds the reference ResidualBlockG's parameters under its
state_dict names (`src/generator/residual_block.py:9-27`): `fusion_block_
{1..4}`, `conv_1`, `conv_2`, `scale_conv` (a 1x1 conv, only when the
channel count changes) and the scalar `gamma` (shape [1], zero init).
`res_block_g` is its forward: two DFBlocks (double affine modulation +
LeakyReLU, then a 3x3 conv), the shortcut, and `shortcut + gamma * h`.

Each DFBlock dispatches as the JAX package's kernel path does
(`blocks.py:74-86`): to kernel K2 (`fused_modconv3x3`) where its
`_supported` holds, else to kernel K1 plus a torch conv. Both kernels are
autograd Functions, so gradients reach the affine MLPs, the conv weights
(through the HWIO copy) and `gamma`.

`res_block_g_up` is `res_block_g` after a nearest 2x upsample, in the
order of the JAX package's default generator path (`fuse_upsample`,
`blocks.py:121-173`): DFBlock-1's modulation chain and the 1x1 shortcut
at low resolution. It takes the same `ResidualBlockG` and is on none of
the port's model paths, which keep the JAX kernel path's order.

`ResidualBlockD` holds the reference ResidualBlockD's parameters
(`src/discriminator/residual_block.py:7-30`): `residual_conv.{0,2}` (4x4
stride-2 and 3x3 convs, no bias, each followed by LeakyReLU), `scale_conv`
(1x1, only when the channel count changes) and `gamma`. `res_block_d` is
its forward. D has no kernel of its own: its convs stay torch ops, which
the MA-GP differentiates twice.
"""
from __future__ import annotations

import torch
from torch import nn

from . import fusion
from . import nn as ops_nn
from .fusion import AffineBlock
from .kernels.fused_modconv import _supported, fused_modconv3x3


class ResidualBlockG(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, sentence_dim: int = 256,
                 affine_hidden: int = 256):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.fusion_block_1 = AffineBlock(sentence_dim, affine_hidden, in_ch)
        self.fusion_block_2 = AffineBlock(sentence_dim, affine_hidden, in_ch)
        self.conv_1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.fusion_block_3 = AffineBlock(sentence_dim, affine_hidden, out_ch)
        self.fusion_block_4 = AffineBlock(sentence_dim, affine_hidden, out_ch)
        self.conv_2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.scale_conv = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                           else None)

    def forward(self, x: torch.Tensor,
                sentence_embed: torch.Tensor) -> torch.Tensor:
        return res_block_g(self, x, sentence_embed)


def _df_block(affine_a: AffineBlock, affine_b: AffineBlock, conv: nn.Conv2d,
              x: torch.Tensor, sentence_embed: torch.Tensor) -> torch.Tensor:
    """One DFBlock: lrelu(affine_b(lrelu(affine_a(x)))) then the 3x3 conv."""
    dt = x.dtype
    w = conv.weight.to(dt).permute(2, 3, 1, 0)  # OIHW -> HWIO
    if _supported(w):
        g1, b1 = fusion.affine_params(affine_a, sentence_embed)
        g2, b2 = fusion.affine_params(affine_b, sentence_embed)
        # w stays a strided HWIO view: K2's wrapper packs it once per
        # forward into the layout its weight stages stream
        return fused_modconv3x3(x, g1.to(dt), b1.to(dt), g2.to(dt),
                                b2.to(dt), w, conv.bias.to(dt))
    h = fusion.double_affine_leaky(affine_a, affine_b, x, sentence_embed)
    return ops_nn.conv2d(h, conv.weight, conv.bias, padding=1)


def res_block_g(block: ResidualBlockG, x: torch.Tensor,
                sentence_embed: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, Cin] NHWC -> [B, H, W, Cout]."""
    h = _df_block(block.fusion_block_1, block.fusion_block_2, block.conv_1,
                  x, sentence_embed)
    h = _df_block(block.fusion_block_3, block.fusion_block_4, block.conv_2,
                  h, sentence_embed)
    shortcut = x
    if block.scale_conv is not None:
        shortcut = ops_nn.conv2d(x, block.scale_conv.weight,
                                 block.scale_conv.bias)
    return shortcut + block.gamma.to(x.dtype) * h


def res_block_g_up(block: ResidualBlockG, x_low: torch.Tensor,
                   sentence_embed: torch.Tensor) -> torch.Tensor:
    """== res_block_g(block, upsample_nearest_2x(x_low), sentence_embed),
    up to the order of the conv sums; x_low [B, h, w, Cin] NHWC ->
    [B, 2h, 2w, Cout].

    Nearest upsampling commutes with every per-pixel op, so DFBlock-1's
    modulation chain runs at low resolution (kernel K1, a quarter of the
    pixels), then the map is upsampled for conv_1 (a torch conv); DFBlock-2
    sees the high-resolution map as in `res_block_g` (K2 where
    `_supported`); the 1x1 shortcut also runs at low resolution, then is
    upsampled."""
    h = fusion.double_affine_leaky(block.fusion_block_1, block.fusion_block_2,
                                   x_low, sentence_embed)
    h = ops_nn.conv2d(ops_nn.upsample_nearest_2x(h), block.conv_1.weight,
                      block.conv_1.bias, padding=1)
    h = _df_block(block.fusion_block_3, block.fusion_block_4, block.conv_2,
                  h, sentence_embed)
    shortcut = x_low
    if block.scale_conv is not None:
        shortcut = ops_nn.conv2d(x_low, block.scale_conv.weight,
                                 block.scale_conv.bias)
    shortcut = ops_nn.upsample_nearest_2x(shortcut)
    return shortcut + block.gamma.to(x_low.dtype) * h


class ResidualBlockD(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.residual_conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 4, 2, 1, bias=False), ops_nn.LeakyReLU(),
            nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False),
            ops_nn.LeakyReLU())
        self.scale_conv = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                           else None)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return res_block_d(self, x)


def res_block_d(block: ResidualBlockD, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, Cin] NHWC -> [B, H/2, W/2, Cout].

    The shortcut is computed as the JAX package computes it
    (`blocks.py:225-234`): avg_pool(conv1x1(x) + bias) is one 2x2 stride-2
    conv whose kernel is the 1x1 kernel / 4 over the window (bias
    unchanged); the identity branch is the plain 2x2 pool."""
    h = ops_nn.conv2d(x, block.residual_conv[0].weight, stride=2, padding=1)
    h = ops_nn.leaky_relu(h)
    h = ops_nn.conv2d(h, block.residual_conv[2].weight, padding=1)
    h = ops_nn.leaky_relu(h)
    if block.scale_conv is not None:
        w = block.scale_conv.weight / 4.0
        shortcut = ops_nn.conv2d(x, w.expand(-1, -1, 2, 2),
                                 block.scale_conv.bias, stride=2)
    else:
        shortcut = ops_nn.avg_pool2d(x, 2)
    return shortcut + block.gamma.to(x.dtype) * h

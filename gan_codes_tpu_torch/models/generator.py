"""One-stage text-to-image generator (the port of
`gan_codes_tpu/models/generator.py`).

Reference Generator (`src/generator/model.py:8-46`): latent -> Linear ->
[B, 4, 4, 8nc] seed -> residual blocks with nearest-2x upsampling ->
LeakyReLU -> 3x3 conv -> tanh -> [B, H, W, 3] in [-1, 1]. Parameters carry
the reference's state_dict names (`linear_in`, `res_blocks.{i}`,
`res_block_out`, `conv_out.1`), so a reference `gen_N.pth` loads with
`load_state_dict(strict=True)`.

The forward follows the JAX package's kernel path (`generator_apply` with
`use_pallas=True`, `generator.py:83-104`): block 0, then upsample -> block
for every later block, so each DFBlock runs through the CUDA kernels.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import GeneratorConfig
from ..ops import nn as ops_nn
from ..ops.blocks import ResidualBlockG, res_block_g


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.linear_in = nn.Linear(
            cfg.latent_dim, cfg.seed_channels * cfg.base_size * cfg.base_size)
        ladder = cfg.block_channels
        self.res_blocks = nn.ModuleList(
            ResidualBlockG(i, o, cfg.sentence_dim, cfg.affine_hidden)
            for i, o in ladder[:-1])
        self.res_block_out = ResidualBlockG(*ladder[-1], cfg.sentence_dim,
                                            cfg.affine_hidden)
        self.conv_out = nn.Sequential(nn.LeakyReLU(0.2),
                                      nn.Conv2d(cfg.n_channels, 3, 3,
                                                padding=1),
                                      nn.Tanh())

    def forward(self, noise: torch.Tensor,
                sentence_embed: torch.Tensor) -> torch.Tensor:
        """noise [B, latent_dim], sentence_embed [B, sentence_dim] ->
        images [B, H, W, 3] NHWC in noise's dtype."""
        cfg = self.cfg
        b = noise.shape[0]
        x = ops_nn.dense(noise, self.linear_in.weight, self.linear_in.bias)
        # the reference's NCHW seed [B, 8nc, 4, 4], then NHWC
        x = x.view(b, cfg.seed_channels, cfg.base_size, cfg.base_size)
        x = x.permute(0, 2, 3, 1).contiguous()
        blocks = list(self.res_blocks) + [self.res_block_out]
        for i, block in enumerate(blocks):
            if i:
                x = ops_nn.upsample_nearest_2x(x)
            x = res_block_g(block, x, sentence_embed)
        x = ops_nn.leaky_relu(x)
        conv = self.conv_out[1]
        x = ops_nn.conv2d(x, conv.weight, conv.bias, padding=1)
        return torch.tanh(x)

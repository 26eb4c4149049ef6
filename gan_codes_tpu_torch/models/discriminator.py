"""Matching-aware discriminator (the port of
`gan_codes_tpu/models/discriminator.py`).

Reference Discriminator (`src/discriminator/model.py:8-58`): a 3x3 conv stem
and strided residual blocks take the image to [B, 4, 4, 16nc] embeds
(`img_forward.*`); the logits tile the sentence embedding over that grid,
concatenate it on channels, and run a 3x3 conv (no bias) -> LeakyReLU -> 4x4
VALID conv (no bias) (`img_sentence_forward.{0,2}`) to [B, 1, 1, 1].
Parameters carry the reference's state_dict names.

`embeds` and `logits` stay two calls: the trainer reuses the real-image
embeds for the shift-by-one mismatched pairs
(`src/deep_fusion_gan/model.py:177-180`). NHWC throughout. Weights are cast
to the input's dtype at use, so a bfloat16 input computes in bfloat16 with
float32 parameters.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import DiscriminatorConfig
from ..ops import nn as ops_nn
from ..ops.blocks import ResidualBlockD, res_block_d


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        self.img_forward = nn.Sequential(
            nn.Conv2d(3, cfg.n_channels, 3, padding=1),
            *(ResidualBlockD(i, o) for i, o in cfg.block_channels))
        self.img_sentence_forward = nn.Sequential(
            nn.Conv2d(cfg.embed_channels + cfg.sentence_dim,
                      cfg.n_channels * 2, 3, padding=1, bias=False),
            nn.LeakyReLU(0.2),
            nn.Conv2d(cfg.n_channels * 2, 1, cfg.final_size, bias=False))

    def embeds(self, image: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 4, 4, embed_channels]."""
        stem = self.img_forward[0]
        x = ops_nn.conv2d(image, stem.weight, stem.bias, padding=1)
        for block in self.img_forward[1:]:
            x = res_block_d(block, x)
        return x

    def logits(self, image_embed: torch.Tensor,
               sentence_embed: torch.Tensor) -> torch.Tensor:
        """([B, 4, 4, C], [B, S]) -> [B, 1, 1, 1] matching-aware logits."""
        b, h, w, _ = image_embed.shape
        sent = sentence_embed[:, None, None, :].expand(
            b, h, w, sentence_embed.shape[-1]).to(image_embed.dtype)
        joint = torch.cat([image_embed, sent], dim=-1)
        x = ops_nn.conv2d(joint, self.img_sentence_forward[0].weight,
                          padding=1)
        x = ops_nn.leaky_relu(x)
        return ops_nn.conv2d(x, self.img_sentence_forward[2].weight)

    def forward(self, image: torch.Tensor,
                sentence_embed: torch.Tensor) -> torch.Tensor:
        return self.logits(self.embeds(image), sentence_embed)

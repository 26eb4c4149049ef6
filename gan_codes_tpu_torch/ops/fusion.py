"""Deep-fusion affine modulation (the port of `gan_codes_tpu/ops/fusion.py`).

Reference AffineBlock (`src/generator/fusion_block.py:5-39`): two 2-layer
MLPs map the sentence embedding to a per-channel scale gamma and shift
beta, broadcast over H x W; the feature map is modulated `gamma * x + beta`.
The MLPs are tiny matmuls left to PyTorch; the [B, H, W, C] modulation
chain is the bandwidth-bound part and runs through kernel K1
(`ops/kernels/fused_affine.py`) or, fused with the conv, K2.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from . import nn as ops_nn
from .kernels.fused_affine import fused_double_affine_leaky


class AffineBlock(nn.Module):
    """Reference AffineBlock's parameters: `gamma_mlp.{0,2}` and
    `beta_mlp.{0,2}` (Linear, ReLU, Linear), xavier-normal weights and zero
    biases (`fusion_block.py:22-31`)."""

    def __init__(self, sentence_dim: int, hidden_dim: int,
                 out_channels: int):
        super().__init__()
        self.gamma_mlp = nn.Sequential(nn.Linear(sentence_dim, hidden_dim),
                                       nn.ReLU(),
                                       nn.Linear(hidden_dim, out_channels))
        self.beta_mlp = nn.Sequential(nn.Linear(sentence_dim, hidden_dim),
                                      nn.ReLU(),
                                      nn.Linear(hidden_dim, out_channels))
        for mlp in (self.gamma_mlp, self.beta_mlp):
            for layer in (mlp[0], mlp[2]):
                nn.init.xavier_normal_(layer.weight)
                nn.init.zeros_(layer.bias)

    def forward(self, sentence_embed: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return affine_params(self, sentence_embed)


def _mlp(mlp: nn.Sequential, s: torch.Tensor) -> torch.Tensor:
    h = torch.relu(ops_nn.dense(s, mlp[0].weight, mlp[0].bias))
    return ops_nn.dense(h, mlp[2].weight, mlp[2].bias)


def affine_params(block: AffineBlock, sentence_embed: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample per-channel (gamma, beta): [B, C] each, in the sentence
    embedding's dtype."""
    return (_mlp(block.gamma_mlp, sentence_embed),
            _mlp(block.beta_mlp, sentence_embed))


def modulate(x: torch.Tensor, gamma: torch.Tensor,
             beta: torch.Tensor) -> torch.Tensor:
    """gamma * x + beta with [B, C] params broadcast over NHWC maps."""
    return gamma[:, None, None, :] * x + beta[:, None, None, :]


def double_affine_leaky(affine_a: AffineBlock, affine_b: AffineBlock,
                        x: torch.Tensor,
                        sentence_embed: torch.Tensor) -> torch.Tensor:
    """The DFBlock pre-conv chain lrelu(affine_b(lrelu(affine_a(x)))),
    through kernel K1 (its plain version for CPU tensors)."""
    g1, b1 = affine_params(affine_a, sentence_embed)
    g2, b2 = affine_params(affine_b, sentence_embed)
    dt = x.dtype
    return fused_double_affine_leaky(x, g1.to(dt), b1.to(dt), g2.to(dt),
                                     b2.to(dt))

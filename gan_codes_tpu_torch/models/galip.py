"""GALIP's generator and discriminator (Tao, Bao, Jing, Wu: "GALIP:
Generative Adversarial CLIPs for Text-to-Image Synthesis", CVPR 2023;
github.com/tobran/GALIP `models/GALIP.py`), NHWC, with GALIP's parameter
names.

`NetG(noise, sentence)`: c = cat(noise, sentence) is the condition of
every affine; `fc_code` makes a code map [B, 7, 7, 64]; the CLIP adapter
(`mapping`) runs `n_mblocks` M_Blocks on it (h = c_sc(x) +
fuse2(conv2(fuse1(conv1(x)))), each `fuse` a DFBLK: lrelu(affine1(
lrelu(affine0(h, c)), c))), `conv_fuse` (5x5) to the CLIP width f, the
frozen visual tower as the mapper on f with the prompts `fc_prompt(c)`
(`models/clip.py::CLIP.map_features`), and `conv` (5x5) of f + 0.1 x the
mapped map; then the G_Blocks, each h = resize_nearest(h); c_sc(h) +
c2(fuse2(c1(fuse1(h)))), with no residual gamma; and `to_rgb`,
tanh(conv3x3(lrelu(h))). Each `cN(fuseN(.))` of a G_Block is a DFBlock of
DF-GAN's form, and runs through `ops/blocks.py::_df_block`: kernel K2 where
its `_supported` holds (every G_Block at the published widths), else K1
and a torch conv. The affine MLPs are `Linear(cond, C) -> ReLU ->
Linear(C, C)` (`fc_gamma`, `fc_beta`, with `linear1`, `linear2`).

The visual tower is not a submodule of NetG: it is frozen, shared with
the discriminator's side (`GALIPDiscriminator` reads its local features)
and given to NetG's constructor; NetG's state_dict and parameters are its
own trainable ones.

`GALIPDiscriminator` holds NetD (`netD`: D_Blocks on the CLIP local
features, out = x' + gamma r (+ beta clip_feat), x' = conv_s(x) where the
width changes) and NetC (`netC`: the sentence tiled over the 7 x 7 map,
concatenated, conv4x4 -> lrelu -> conv4x4, no bias).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch
from torch import nn

from ..config import CLIPConfig, GALIPDiscriminatorConfig, GALIPGeneratorConfig
from ..ops import fusion
from ..ops import nn as ops_nn
from ..ops.blocks import _df_block

MAPPER_SCALE = 0.1  # GALIP's weight of the mapped map in conv(f + 0.1 m)


def _mlp(cond_dim: int, c: int) -> nn.Sequential:
    return nn.Sequential(OrderedDict([("linear1", nn.Linear(cond_dim, c)),
                                      ("relu1", nn.ReLU()),
                                      ("linear2", nn.Linear(c, c))]))


class Affine(nn.Module):
    """GALIP's Affine: gamma = fc_gamma(c), beta = fc_beta(c) [B, C]; its
    init puts gamma at 1 and beta at 0 (`linear2` zero, gamma's bias one).
    `gamma_mlp` / `beta_mlp` name them for `ops/fusion.py::affine_params`,
    which indexes each MLP's linear layers 0 and 2."""

    def __init__(self, cond_dim: int, c: int):
        super().__init__()
        self.fc_gamma = _mlp(cond_dim, c)
        self.fc_beta = _mlp(cond_dim, c)
        nn.init.zeros_(self.fc_gamma.linear2.weight)
        nn.init.ones_(self.fc_gamma.linear2.bias)
        nn.init.zeros_(self.fc_beta.linear2.weight)
        nn.init.zeros_(self.fc_beta.linear2.bias)

    @property
    def gamma_mlp(self) -> nn.Sequential:
        return self.fc_gamma

    @property
    def beta_mlp(self) -> nn.Sequential:
        return self.fc_beta


class DFBLK(nn.Module):
    def __init__(self, cond_dim: int, c: int):
        super().__init__()
        self.affine0 = Affine(cond_dim, c)
        self.affine1 = Affine(cond_dim, c)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """lrelu(affine1(lrelu(affine0(x)))) through kernel K1."""
        return fusion.double_affine_leaky(self.affine0, self.affine1, x, c)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return ops_nn.conv2d(x, conv.weight, conv.bias, stride=conv.stride[0],
                         padding=conv.padding[0])


class M_Block(nn.Module):  # noqa: N801 (GALIP's name)
    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, cond_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid_ch, 3, 1, 1)
        self.fuse1 = DFBLK(cond_dim, mid_ch)
        self.conv2 = nn.Conv2d(mid_ch, out_ch, 3, 1, 1)
        self.fuse2 = DFBLK(cond_dim, out_ch)
        self.c_sc = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.fuse1(_conv(self.conv1, x), c)
        h = self.fuse2(_conv(self.conv2, h), c)
        sc = x if self.c_sc is None else _conv(self.c_sc, x)
        return sc + h


class G_Block(nn.Module):  # noqa: N801 (GALIP's name)
    def __init__(self, cond_dim: int, in_ch: int, out_ch: int, size: int):
        super().__init__()
        self.size = size
        self.c1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.c2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.fuse1 = DFBLK(cond_dim, in_ch)
        self.fuse2 = DFBLK(cond_dim, out_ch)
        self.c_sc = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return g_block(self, h, c)


def g_block(block: G_Block, h: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """h [B, s, s, Cin] NHWC -> [B, size, size, Cout]: the resize, then
    two DFBlocks on K2 (`_df_block`) beside the shortcut."""
    if h.shape[1] != block.size:
        h = ops_nn.resize_nearest(h, block.size)
    r = _df_block(block.fuse1.affine0, block.fuse1.affine1, block.c1, h, c)
    r = _df_block(block.fuse2.affine0, block.fuse2.affine1, block.c2, r, c)
    sc = h if block.c_sc is None else _conv(block.c_sc, h)
    return sc + r


class CLIPAdapter(nn.Module):
    def __init__(self, cfg: GALIPGeneratorConfig, clip_cfg: CLIPConfig,
                 tower):
        super().__init__()
        w, cond = clip_cfg.vision_width, cfg.cond_dim
        self.clip_width, self.n_prompts = w, cfg.n_prompts
        self.FBlocks = nn.ModuleList(
            [M_Block(cfg.code_ch, cfg.mid_ch, cfg.code_ch, cond)
             for _ in range(cfg.n_mblocks)])
        self.conv_fuse = nn.Conv2d(cfg.code_ch, w, 5, 1, 2)
        self.conv = nn.Conv2d(w, 8 * cfg.n_channels, 5, 1, 2)
        self.fc_prompt = nn.Linear(cond, w * cfg.n_prompts)
        self._tower = (tower,)  # the frozen CLIP: not a submodule

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        prompts = ops_nn.dense(c, self.fc_prompt.weight,
                               self.fc_prompt.bias).view(
            c.shape[0], self.n_prompts, self.clip_width)
        for block in self.FBlocks:
            x = block(x, c)
        f = _conv(self.conv_fuse, x)
        m = self._tower[0].map_features(f, prompts)
        return _conv(self.conv, f + MAPPER_SCALE * m)


class NetG(nn.Module):
    def __init__(self, cfg: GALIPGeneratorConfig, clip_cfg: CLIPConfig,
                 tower):
        """`tower`: the frozen `models/clip.py::CLIP` whose visual blocks
        are the mapper."""
        super().__init__()
        self.cfg = cfg
        self.code = (clip_cfg.grid, cfg.code_ch)
        self.fc_code = nn.Linear(cfg.latent_dim,
                                 clip_cfg.grid ** 2 * cfg.code_ch)
        self.mapping = CLIPAdapter(cfg, clip_cfg, tower)
        self.GBlocks = nn.ModuleList(
            G_Block(cfg.cond_dim, i, o, s) for (i, o), s in
            zip(cfg.block_channels, cfg.block_sizes))
        self.to_rgb = nn.Sequential(ops_nn.LeakyReLU(),
                                    nn.Conv2d(cfg.n_channels, 3, 3, 1, 1))

    def forward(self, noise: torch.Tensor, sentence: torch.Tensor
                ) -> torch.Tensor:
        """noise [B, Z], sentence [B, S] -> images [B, H, W, 3] NHWC in
        [-1, 1]."""
        b = noise.shape[0]
        g, ch = self.code
        c = torch.cat([noise, sentence.to(noise.dtype)], dim=1)
        x = ops_nn.dense(noise, self.fc_code.weight, self.fc_code.bias)
        # GALIP's NCHW code [B, 64, 7, 7], then NHWC
        x = x.view(b, ch, g, g).permute(0, 2, 3, 1).contiguous()
        x = self.mapping(x, c)
        for block in self.GBlocks:
            x = g_block(block, x, c)
        x = _conv(self.to_rgb[1], ops_nn.leaky_relu(x))
        return torch.tanh(x)


class D_Block(nn.Module):  # noqa: N801 (GALIP's name)
    def __init__(self, fin: int, fout: int, clip_feat: bool):
        super().__init__()
        self.conv_r = nn.Sequential(
            nn.Conv2d(fin, fout, 3, 1, 1, bias=False), ops_nn.LeakyReLU(),
            nn.Conv2d(fout, fout, 3, 1, 1, bias=False), ops_nn.LeakyReLU())
        self.conv_s = nn.Conv2d(fin, fout, 1)
        self.learned_shortcut = fin != fout
        self.gamma = nn.Parameter(torch.zeros(1))
        self.beta = nn.Parameter(torch.zeros(1)) if clip_feat else None

    def forward(self, x: torch.Tensor, clip_feat: torch.Tensor = None
                ) -> torch.Tensor:
        r = ops_nn.leaky_relu(ops_nn.conv2d(x, self.conv_r[0].weight,
                                            padding=1))
        r = ops_nn.leaky_relu(ops_nn.conv2d(r, self.conv_r[2].weight,
                                            padding=1))
        if self.learned_shortcut:
            x = _conv(self.conv_s, x)
        out = x + self.gamma.to(x.dtype) * r
        if self.beta is not None:
            out = out + self.beta.to(x.dtype) * clip_feat
        return out


class NetD(nn.Module):
    def __init__(self, cfg: GALIPDiscriminatorConfig, width: int):
        super().__init__()
        n = len(cfg.local_layers)
        self.DBlocks = nn.ModuleList(D_Block(width, width, True)
                                     for _ in range(n - 1))
        self.main = D_Block(width, 8 * cfg.n_channels, False)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, L, g, g, W] -> [B, g, g, 8 nf]."""
        out = feats[:, 0]
        for i, block in enumerate(self.DBlocks):
            out = block(out, feats[:, i + 1])
        return self.main(out)


class NetC(nn.Module):
    def __init__(self, cfg: GALIPDiscriminatorConfig):
        super().__init__()
        nf = cfg.n_channels
        self.joint_conv = nn.Sequential(
            nn.Conv2d(8 * nf + cfg.sentence_dim, 2 * nf, 4, 1, 0, bias=False),
            ops_nn.LeakyReLU(),
            nn.Conv2d(2 * nf, 1, 4, 1, 0, bias=False))

    def forward(self, h: torch.Tensor, sentence: torch.Tensor
                ) -> torch.Tensor:
        """h [B, g, g, C], sentence [B, S] -> logits [B, 1, 1, 1] (NHWC,
        on a 7 x 7 map)."""
        b, g, _, _ = h.shape
        s = sentence.to(h.dtype)[:, None, None, :].expand(
            b, g, g, sentence.shape[-1])
        x = ops_nn.conv2d(torch.cat([h, s], dim=-1),
                          self.joint_conv[0].weight)
        return ops_nn.conv2d(ops_nn.leaky_relu(x), self.joint_conv[2].weight)


class GALIPDiscriminator(nn.Module):
    """NetD and NetC, the modules D's optimizer steps (GALIP's `netD`,
    `netC`)."""

    def __init__(self, cfg: GALIPDiscriminatorConfig, clip_cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.netD = NetD(cfg, clip_cfg.vision_width)
        self.netC = NetC(cfg)

    def logits(self, feats: torch.Tensor, sentence: torch.Tensor
               ) -> torch.Tensor:
        """C(D(feats), sentence) [B, 1, 1, 1]."""
        return self.netC(self.netD(feats), sentence)

    def forward(self, feats: torch.Tensor, sentence: torch.Tensor
                ) -> torch.Tensor:
        return self.logits(feats, sentence)


def build(cfg, clip) -> Tuple[NetG, GALIPDiscriminator]:
    """GALIP's G and D + C for a `GALIPConfig`, G's mapper on `clip`."""
    return (NetG(cfg.generator, cfg.text_encoder, clip),
            GALIPDiscriminator(cfg.discriminator, cfg.text_encoder))

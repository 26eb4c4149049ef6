"""Seeded random weights of a GALIP configuration, made on the device.

Names and shapes follow the modules' state_dicts: OpenAI's CLIP names for
the towers (`visual.conv1.weight`, `transformer.resblocks.{i}...`), and
GALIP's for NetG (`fc_code`, `mapping.FBlocks.{i}...`, `GBlocks.{i}...`,
`to_rgb.1`) and for NetD + NetC (`netD.DBlocks.{i}...`, `netD.main...`,
`netC.joint_conv.{0,2}`), worked out from the configuration's sizes, so
that the port loads them strictly and the plain reference reads them as
they are. Drawn as `weights.make` draws (one uniform and one normal pool
a module, cut in name order). The distributions are torch's default
inits, with every branch live: D's scalar gamma and beta in [0.25,
0.75] (GALIP starts them at 0), each affine's second layer drawn (GALIP
starts it at 0) with fc_gamma's bias in [0.75, 1.25], and the LayerNorms'
scales in [0.75, 1.25] with small biases.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import workgen
from .weights import Leaf, _conv, _linear

LIVE = ("r", (0.25, 0.75))
NEAR_ONE = ("r", (0.75, 1.25))


def g_block_channels(g: dict):
    """(in, out) of each G_Block: nf * min(2^i, 8) reversed, paired."""
    n = int(math.log2(g["image_size"])) - 1
    chans = [g["n_channels"] * min(2 ** i, 8) for i in range(n)][::-1]
    return list(zip(chans[:-1], chans[1:]))


def g_block_sizes(g: dict) -> List[int]:
    n = len(g_block_channels(g))
    return [8 * 2 ** i for i in range(n - 1)] + [g["image_size"]]


def grid(c: dict) -> int:
    return c["image_resolution"] // c["vision_patch_size"]


def _ln(name: str, w: int) -> List[Leaf]:
    return [(f"{name}.weight", (w,)) + NEAR_ONE,
            (f"{name}.bias", (w,), "u", 0.1)]


def _block(pre: str, w: int) -> List[Leaf]:
    a = 1.0 / math.sqrt(w)
    return ([(f"{pre}.attn.in_proj_weight", (3 * w, w), "u", a),
             (f"{pre}.attn.in_proj_bias", (3 * w,), "u", a),
             (f"{pre}.attn.out_proj.weight", (w, w), "u", a),
             (f"{pre}.attn.out_proj.bias", (w,), "u", a)]
            + _ln(f"{pre}.ln_1", w)
            + _linear(f"{pre}.mlp.c_fc", w, 4 * w)
            + _linear(f"{pre}.mlp.c_proj", 4 * w, w)
            + _ln(f"{pre}.ln_2", w))


def clip_leaves(cfg: dict) -> List[Leaf]:
    c = cfg["text_encoder"]
    vw, tw, e = c["vision_width"], c["transformer_width"], c["embed_dim"]
    p = c["vision_patch_size"]
    leaves = [("visual.class_embedding", (vw,), "n", vw ** -0.5),
              ("visual.positional_embedding", (grid(c) ** 2 + 1, vw), "n",
               vw ** -0.5),
              ("visual.proj", (vw, e), "n", vw ** -0.5)]
    leaves += _conv("visual.conv1", 3, vw, p, bias=False)
    leaves += _ln("visual.ln_pre", vw)
    for i in range(c["vision_layers"]):
        leaves += _block(f"visual.transformer.resblocks.{i}", vw)
    leaves += _ln("visual.ln_post", vw)
    leaves += [("positional_embedding", (c["context_length"], tw), "n",
                0.01),
               ("text_projection", (tw, e), "n", tw ** -0.5),
               ("logit_scale", (), "r", (4.6052, 4.6052)),
               ("token_embedding.weight", (c["vocab_size"], tw), "n", 0.02)]
    for i in range(c["transformer_layers"]):
        leaves += _block(f"transformer.resblocks.{i}", tw)
    return leaves + _ln("ln_final", tw)


def _affine(pre: str, cond: int, ch: int) -> List[Leaf]:
    out = []
    for mlp in ("fc_gamma", "fc_beta"):
        out += _linear(f"{pre}.{mlp}.linear1", cond, ch)
        out += [(f"{pre}.{mlp}.linear2.weight", (ch, ch), "u",
                 1.0 / math.sqrt(ch))]
        out += [(f"{pre}.{mlp}.linear2.bias", (ch,)) + NEAR_ONE
                if mlp == "fc_gamma" else
                (f"{pre}.{mlp}.linear2.bias", (ch,), "u", 1.0 / math.sqrt(ch))]
    return out


def _dfblk(pre: str, cond: int, ch: int) -> List[Leaf]:
    return _affine(f"{pre}.affine0", cond, ch) + _affine(f"{pre}.affine1",
                                                         cond, ch)


def generator_leaves(cfg: dict) -> List[Leaf]:
    g, c = cfg["generator"], cfg["text_encoder"]
    cond = g["latent_dim"] + g["sentence_dim"]
    w, code = c["vision_width"], g["code_ch"]
    leaves = _linear("fc_code", g["latent_dim"], grid(c) ** 2 * code)
    for i in range(g["n_mblocks"]):
        pre = f"mapping.FBlocks.{i}"
        leaves += _conv(f"{pre}.conv1", code, g["mid_ch"], 3)
        leaves += _dfblk(f"{pre}.fuse1", cond, g["mid_ch"])
        leaves += _conv(f"{pre}.conv2", g["mid_ch"], code, 3)
        leaves += _dfblk(f"{pre}.fuse2", cond, code)
    leaves += _conv("mapping.conv_fuse", code, w, 5)
    leaves += _conv("mapping.conv", w, 8 * g["n_channels"], 5)
    leaves += _linear("mapping.fc_prompt", cond, w * g["n_prompts"])
    for i, (ci, co) in enumerate(g_block_channels(g)):
        pre = f"GBlocks.{i}"
        leaves += _conv(f"{pre}.c1", ci, co, 3) + _conv(f"{pre}.c2", co, co,
                                                        3)
        leaves += _dfblk(f"{pre}.fuse1", cond, ci)
        leaves += _dfblk(f"{pre}.fuse2", cond, co)
        if ci != co:
            leaves += _conv(f"{pre}.c_sc", ci, co, 1)
    return leaves + _conv("to_rgb.1", g["n_channels"], 3, 3)


def discriminator_leaves(cfg: dict) -> List[Leaf]:
    d, c = cfg["discriminator"], cfg["text_encoder"]
    w, nf = c["vision_width"], d["n_channels"]
    leaves: List[Leaf] = []
    blocks = [(f"netD.DBlocks.{i}", w, w, True)
              for i in range(len(d["local_layers"]) - 1)]
    for pre, fin, fout, beta in blocks + [("netD.main", w, 8 * nf, False)]:
        leaves += _conv(f"{pre}.conv_r.0", fin, fout, 3, bias=False)
        leaves += _conv(f"{pre}.conv_r.2", fout, fout, 3, bias=False)
        leaves += _conv(f"{pre}.conv_s", fin, fout, 1)
        leaves.append((f"{pre}.gamma", (1,)) + LIVE)
        if beta:
            leaves.append((f"{pre}.beta", (1,)) + LIVE)
    leaves += _conv("netC.joint_conv.0", 8 * nf + d["sentence_dim"], 2 * nf,
                    4, bias=False)
    return leaves + _conv("netC.joint_conv.2", 2 * nf, 1, 4, bias=False)


LEAVES = {"clip": clip_leaves, "generator": generator_leaves,
          "discriminator": discriminator_leaves}


@torch.no_grad()
def make(cfg: dict, module: str, seed: int, device: str | torch.device
         ) -> Dict[str, torch.Tensor]:
    """The float32 state_dict of `module` ("clip", "generator",
    "discriminator") for `seed`, on `device`."""
    leaves = LEAVES[module](cfg)
    gen = torch.Generator(device=device).manual_seed(
        workgen.torch_seed(seed, f"weights.galip.{module}"))
    size = {k: sum(math.prod(s) for _, s, kind, _ in leaves
                   if (kind == "n") == (k == "n")) for k in ("u", "n")}
    pools = {"u": torch.rand(size["u"], generator=gen, device=device),
             "n": torch.randn(size["n"], generator=gen, device=device)}
    at = {"u": 0, "n": 0}
    out = {}
    for name, shape, kind, a in leaves:
        pool = "n" if kind == "n" else "u"
        n = math.prod(shape)
        x = pools[pool][at[pool]:at[pool] + n].view(shape)
        at[pool] += n
        if kind == "u":
            out[name] = (x * 2.0 - 1.0) * a
        elif kind == "r":
            out[name] = a[0] + x * (a[1] - a[0])
        else:
            out[name] = x * a
    return out

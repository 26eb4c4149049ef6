"""Seeded random weights of a configuration, made on the device.

Names and shapes follow the reference's state_dicts (`gen_N.pth`, D, the
text encoder's `text_encoder.pth`), worked out here from the
configuration's sizes, so that the port loads them with
`load_state_dict(strict=True)` and the plain reference reads them as they
are. Each module's weights come from one `torch.Generator` on the device
in two large draws (one uniform, one normal), cut into leaves in name
order; the distributions are torch's default inits, with every block's
residual gamma drawn in [0.25, 0.75], away from its zero init, so that
each block's convs reach the output.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import workgen

# (name, shape, kind, a): kind "u" U(-a, a); "r" U(a[0], a[1]); "n" N(0, a)
Leaf = Tuple[str, Tuple[int, ...], str, object]


def g_block_channels(g: dict) -> List[Tuple[int, int]]:
    """(in, out) channels of each generator block, 4 x 4 upwards."""
    nc = g["n_channels"]
    n_up = int(math.log2(g["image_size"] // g["base_size"]))
    return ([(8 * nc, 8 * nc)] * (n_up - 2) + [(8 * nc, 4 * nc),
                                               (4 * nc, 2 * nc)]
            + [(2 * nc, nc)])


def d_block_channels(d: dict, image_size: int) -> List[Tuple[int, int]]:
    """(in, out) channels of each discriminator down block."""
    nc = d["n_channels"]
    mults = [1, 2, 4, 8, 16, 16, 16]
    n = int(math.log2(image_size // d["final_size"]))
    return [(mults[i] * nc, mults[i + 1] * nc) for i in range(n)]


def _linear(name: str, n_in: int, n_out: int, bias: bool = True
            ) -> List[Leaf]:
    a = 1.0 / math.sqrt(n_in)
    out = [(f"{name}.weight", (n_out, n_in), "u", a)]
    return out + [(f"{name}.bias", (n_out,), "u", a)] if bias else out


def _conv(name: str, cin: int, cout: int, k: int, bias: bool = True
          ) -> List[Leaf]:
    a = 1.0 / math.sqrt(cin * k * k)
    out = [(f"{name}.weight", (cout, cin, k, k), "u", a)]
    return out + [(f"{name}.bias", (cout,), "u", a)] if bias else out


def _affine(name: str, s: int, hidden: int, c: int) -> List[Leaf]:
    leaves = []
    for mlp in ("gamma_mlp", "beta_mlp"):
        for layer, (n_in, n_out) in (("0", (s, hidden)), ("2", (hidden, c))):
            std = math.sqrt(2.0 / (n_in + n_out))  # xavier normal
            leaves += [(f"{name}.{mlp}.{layer}.weight", (n_out, n_in), "n",
                        std),
                       (f"{name}.{mlp}.{layer}.bias", (n_out,), "u",
                        1.0 / math.sqrt(n_in))]
    return leaves


GAMMA = ("r", (0.25, 0.75))


def generator_leaves(cfg: dict) -> List[Leaf]:
    g = cfg["generator"]
    nc, s, hid = g["n_channels"], g["sentence_dim"], g["affine_hidden"]
    leaves = _linear("linear_in", g["latent_dim"],
                     8 * nc * g["base_size"] ** 2)
    ladder = g_block_channels(g)
    for i, (ci, co) in enumerate(ladder):
        p = f"res_blocks.{i}" if i < len(ladder) - 1 else "res_block_out"
        leaves.append((f"{p}.gamma", (1,)) + GAMMA)
        leaves += _affine(f"{p}.fusion_block_1", s, hid, ci)
        leaves += _affine(f"{p}.fusion_block_2", s, hid, ci)
        leaves += _conv(f"{p}.conv_1", ci, co, 3)
        leaves += _affine(f"{p}.fusion_block_3", s, hid, co)
        leaves += _affine(f"{p}.fusion_block_4", s, hid, co)
        leaves += _conv(f"{p}.conv_2", co, co, 3)
        if ci != co:
            leaves += _conv(f"{p}.scale_conv", ci, co, 1)
    return leaves + _conv("conv_out.1", nc, 3, 3)


def discriminator_leaves(cfg: dict) -> List[Leaf]:
    d, g = cfg["discriminator"], cfg["generator"]
    nc = d["n_channels"]
    leaves = _conv("img_forward.0", 3, nc, 3)
    blocks = d_block_channels(d, g["image_size"])
    for i, (ci, co) in enumerate(blocks, start=1):
        p = f"img_forward.{i}"
        leaves.append((f"{p}.gamma", (1,)) + GAMMA)
        leaves += _conv(f"{p}.residual_conv.0", ci, co, 4, bias=False)
        leaves += _conv(f"{p}.residual_conv.2", co, co, 3, bias=False)
        if ci != co:
            leaves += _conv(f"{p}.scale_conv", ci, co, 1)
    leaves += _conv("img_sentence_forward.0", blocks[-1][1]
                    + g["sentence_dim"], 2 * nc, 3, bias=False)
    return leaves + _conv("img_sentence_forward.2", 2 * nc, 1,
                          d["final_size"], bias=False)


def text_encoder_leaves(cfg: dict) -> List[Leaf]:
    t = cfg["text_encoder"]
    h = t["hidden_dim"] // 2  # per direction
    leaves = [("encoder.weight", (t["vocab_size"], t["embed_dim"]), "n",
               1.0)]
    a = 1.0 / math.sqrt(h)
    for sfx in ("", "_reverse"):
        leaves += [(f"rnn.weight_ih_l0{sfx}", (4 * h, t["embed_dim"]), "u",
                    a),
                   (f"rnn.weight_hh_l0{sfx}", (4 * h, h), "u", a),
                   (f"rnn.bias_ih_l0{sfx}", (4 * h,), "u", a),
                   (f"rnn.bias_hh_l0{sfx}", (4 * h,), "u", a)]
    return leaves


LEAVES = {"generator": generator_leaves,
          "discriminator": discriminator_leaves,
          "text_encoder": text_encoder_leaves}


@torch.no_grad()
def make(cfg: dict, module: str, seed: int, device: str | torch.device
         ) -> Dict[str, torch.Tensor]:
    """The float32 state_dict of `module` ("generator", "discriminator",
    "text_encoder") for `seed`, on `device`."""
    leaves = LEAVES[module](cfg)
    gen = torch.Generator(device=device).manual_seed(
        workgen.torch_seed(seed, f"weights.{module}"))
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

"""GALIP's work counts from shapes (`configs/galip-cub224-tf32.json`), as
`flops.py` counts DF-GAN's: 2 operations a multiply-add of the
convolutions and matrix products the step runs, elementwise work (norms,
activations, softmax, modulation, the optimizer) not counted. Attention
counts its two products at full T x T (the text tower's causal mask
included). A layer's backward is its weight gradient, where the weights
train, and its input gradient, where the input depends on a weight that
trains or is differentiated (frozen CLIP passes gradients through, at one
forward's cost).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .flops import BYTES, bound_s, peak_flops
from .weights_galip import g_block_channels, g_block_sizes, grid

# (kind, operations): "w" trains (forward, weight and input gradients),
# "first" trains but takes no input gradient, "frozen" passes gradients.


def transformer_ops(width: int, tokens: int) -> float:
    """One pre-LN block on `tokens` tokens: the fused QKV, the out
    projection and the MLP (12 T W^2 multiply-adds) and the two attention
    products (2 T^2 W)."""
    return 2.0 * (12 * tokens * width ** 2 + 2 * tokens ** 2 * width)


def text_forward(cfg: dict) -> float:
    c = cfg["text_encoder"]
    t, w = c["context_length"], c["transformer_width"]
    return (c["transformer_layers"] * transformer_ops(w, t)
            + 2.0 * w * c["embed_dim"])


def image_forward(cfg: dict) -> float:
    """One CLIP image encode: the patch conv, the blocks on g^2 + 1
    tokens, the projection."""
    c = cfg["text_encoder"]
    w, p, g = c["vision_width"], c["vision_patch_size"], grid(c)
    return (2.0 * g * g * 3 * p * p * w
            + c["vision_layers"] * transformer_ops(w, g * g + 1)
            + 2.0 * w * c["embed_dim"])


def mapper_forward(cfg: dict) -> float:
    """The mapper: the visual blocks, one prompt token more in blocks
    1..n_prompts."""
    c, g = cfg["text_encoder"], cfg["generator"]
    w, n = c["vision_width"], grid(c) ** 2 + 1
    return sum(transformer_ops(w, n + (1 <= i <= g["n_prompts"]))
               for i in range(c["vision_layers"]))


def _affine(cond: int, ch: int) -> List[Tuple[str, float]]:
    """A DFBLK's two affines, two MLPs each (cond -> C -> C)."""
    return [("first", 4 * 2.0 * cond * ch), ("w", 4 * 2.0 * ch * ch)]


def dfblock_shapes(cfg: dict) -> List[Tuple[int, int, int]]:
    """(size, Cin, Cout) of the G_Blocks' ten DFBlock 3x3 convs (K2)."""
    g = cfg["generator"]
    out = []
    for (ci, co), s in zip(g_block_channels(g), g_block_sizes(g)):
        out += [(s, ci, co), (s, co, co)]
    return out


def generator_layers(cfg: dict) -> List[Tuple[str, float]]:
    """NetG's layers of one image, the mapper as one "frozen" entry."""
    g, c = cfg["generator"], cfg["text_encoder"]
    cond = g["latent_dim"] + g["sentence_dim"]
    n = grid(c) ** 2
    w, code, mid = c["vision_width"], g["code_ch"], g["mid_ch"]
    layers = [("first", 2.0 * g["latent_dim"] * n * code),
              ("first", 2.0 * cond * w * g["n_prompts"])]
    for _ in range(g["n_mblocks"]):
        layers += [("w", 2.0 * n * 9 * code * mid),
                   ("w", 2.0 * n * 9 * mid * code)]
        layers += _affine(cond, mid) + _affine(cond, code)
    layers += [("w", 2.0 * n * 25 * code * w),
               ("frozen", mapper_forward(cfg)),
               ("w", 2.0 * n * 25 * w * 8 * g["n_channels"])]
    for (ci, co), s in zip(g_block_channels(g), g_block_sizes(g)):
        layers += _affine(cond, ci) + _affine(cond, co)
        layers += [("w", 2.0 * s * s * 9 * ci * co),
                   ("w", 2.0 * s * s * 9 * co * co)]
        if ci != co:
            layers.append(("w", 2.0 * s * s * ci * co))
    size = g["image_size"]
    return layers + [("w", 2.0 * size * size * 9 * g["n_channels"] * 3)]


def d_layers(cfg: dict) -> Tuple[List[Tuple[str, float]],
                                 List[Tuple[str, float]]]:
    """(NetD's layers, NetC's layers) of one image."""
    d, c = cfg["discriminator"], cfg["text_encoder"]
    w, nf, n = c["vision_width"], d["n_channels"], grid(c) ** 2
    net_d = []
    for _ in range(len(d["local_layers"]) - 1):
        net_d += [("w", 2.0 * n * 9 * w * w)] * 2
    net_d += [("w", 2.0 * n * 9 * w * 8 * nf),
              ("w", 2.0 * n * 9 * 8 * nf * 8 * nf),
              ("w", 2.0 * n * w * 8 * nf)]
    h = grid(c) - 3
    net_c = [("w", 2.0 * h * h * 16 * (8 * nf + d["sentence_dim"]) * 2 * nf),
             ("w", 2.0 * 16 * 2 * nf)]
    return net_d, net_c


def _fwd(layers) -> float:
    return sum(f for _, f in layers)


def _fwd_bwd(layers) -> float:
    """Forward, weight gradients where the weights train, and input
    gradients ("first" takes none)."""
    k = {"w": 3, "first": 2, "frozen": 2}
    return sum(f * k[kind] for kind, f in layers)


def generator_forward_flops(cfg: dict) -> float:
    return _fwd(generator_layers(cfg))


def train_step_flops(cfg: dict) -> float:
    """One step of `batch_size` images (`train/step.py::make_galip_step`):

    - the text tower, forward;
    - G: forward and backward (its mapper: forward and input gradient);
    - D's update: two CLIP image encodes without a graph; NetD on the
      real and the fake features and NetC on three rows (real, fake,
      mismatched), forward and backward; the MA-GP on the real path: the
      input gradient of the logits and its gradient by the weights (two
      forwards a layer more, as `flops.py` counts the penalty's double
      backward: the forward is shared);
    - G's update: a CLIP encode of the fakes with its input gradient,
      NetD and NetC forward and input gradient."""
    b = cfg["train"]["batch_size"]
    net_d, net_c = d_layers(cfg)
    enc = image_forward(cfg)
    d_step = (2 * enc + 2 * _fwd_bwd(net_d) + 3 * _fwd_bwd(net_c)
              + 3 * (_fwd(net_d) + _fwd(net_c)))
    g_step = 2 * enc + 2 * (_fwd(net_d) + _fwd(net_c))
    return b * (text_forward(cfg) + _fwd_bwd(generator_layers(cfg))
                + d_step + g_step)


def k2_work(cfg: dict, batch: int) -> Dict[str, float]:
    """Operations, bytes and the least seconds of the ten G_Block DFBlock
    convs of one G forward of `batch` images (K2's launches), each launch
    bounded on its own: x, the four modulation vectors, the weights and
    the bias read once, the output written once."""
    esize = BYTES[cfg["precision"]]
    peak = peak_flops(cfg)
    flops = n_bytes = least = 0.0
    for s, ci, co in dfblock_shapes(cfg):
        f = 2.0 * batch * s * s * 9 * ci * co
        nb = (batch * s * s * ci + 4 * batch * ci + 9 * ci * co + co
              + batch * s * s * co) * esize
        flops += f
        n_bytes += nb
        least += bound_s(nb, f, peak)[0]
    return {"flops": flops, "bytes": n_bytes, "bound_s": least}

"""Work counts from shapes, and the H100's published peaks.

Operations are the multiply-adds of the convolutions and matrix products
(2 per multiply-add), as the algorithm needs them at the configuration's
sizes; elementwise work (modulation, activations, pooling, the optimizer)
is not counted, nor is the text encoder (about 0.1% of a generator
forward), nor anything a program recomputes. They do not depend on which
kernel ran.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity),
as `chip_smoke.py` holds them: fp32 on the TF32 tensor cores as 3xTF32 is
a third of TF32's rate (the fastest route that keeps fp32's precision, and
the rate K2's and K3's bounds use); "tf32" is one TF32 pass.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .weights import d_block_channels, g_block_channels

H100_TF32_TENSOR_FLOPS = 495e12
H100_BF16_TENSOR_FLOPS = 989e12
H100_FP32_CUDA_CORE_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

PEAK_FLOPS = {"float32": H100_TF32_TENSOR_FLOPS / 3,
              "tf32": H100_TF32_TENSOR_FLOPS,
              "bfloat16": H100_BF16_TENSOR_FLOPS}
BYTES = {"float32": 4, "tf32": 4, "bfloat16": 2}


def peak_flops(cfg: dict) -> float:
    return PEAK_FLOPS[cfg["precision"]]


def bound_s(n_bytes: float, flops: float, peak: float
            ) -> Tuple[float, str]:
    """The least time the chip could take: the larger of the operations
    over the peak and the bytes over the memory's rate."""
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S
    t_ops = flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- one image's layers: (kind, forward operations) -------------------------
# kinds: "in" takes the model's input (no input gradient in G's and D's
# own steps), "mlp0" takes the sentence (no input gradient), else "conv".


def dfblock_shapes(cfg: dict) -> List[Tuple[int, int, int]]:
    """(resolution, Cin, Cout) of the generator's DFBlock 3x3 convs."""
    g = cfg["generator"]
    out = []
    for i, (ci, co) in enumerate(g_block_channels(g)):
        r = g["base_size"] * 2 ** i
        out += [(r, ci, co), (r, co, co)]
    return out


def generator_layers(cfg: dict) -> List[Tuple[str, float]]:
    g = cfg["generator"]
    s, hid = g["sentence_dim"], g["affine_hidden"]
    layers = [("in", 2.0 * g["latent_dim"] * 8 * g["n_channels"]
               * g["base_size"] ** 2)]
    for i, (ci, co) in enumerate(g_block_channels(g)):
        r = g["base_size"] * 2 ** i
        for c in (ci, ci, co, co):       # four affine blocks, two MLPs each
            layers += [("mlp0", 2 * 2.0 * s * hid), ("conv", 2 * 2.0 * hid * c)]
        layers += [("conv", 2.0 * r * r * 9 * ci * co),
                   ("conv", 2.0 * r * r * 9 * co * co)]
        if ci != co:
            layers.append(("conv", 2.0 * r * r * ci * co))
    size = g["image_size"]
    return layers + [("conv", 2.0 * size * size * 9 * g["n_channels"] * 3)]


def discriminator_layers(cfg: dict) -> Tuple[List[Tuple[str, float]],
                                             List[Tuple[str, float]]]:
    """(the embeds' layers, the logits' layers) of one image."""
    d, g = cfg["discriminator"], cfg["generator"]
    r = g["image_size"]
    embeds = [("in", 2.0 * r * r * 9 * 3 * d["n_channels"])]
    blocks = d_block_channels(d, r)
    for ci, co in blocks:
        h = r // 2
        embeds += [("conv", 2.0 * h * h * 16 * ci * co),
                   ("conv", 2.0 * h * h * 9 * co * co)]
        if ci != co:  # the 1x1 shortcut at the input's size, then the pool
            embeds.append(("conv", 2.0 * r * r * ci * co))
        r = h
    nc, f = d["n_channels"], d["final_size"]
    logits = [("conv", 2.0 * f * f * 9 * (blocks[-1][1] + g["sentence_dim"])
               * 2 * nc),
              ("conv", 2.0 * 2 * nc * f * f)]
    return embeds, logits


def _fwd(layers) -> float:
    return sum(f for _, f in layers)


def _fwd_bwd(layers) -> float:
    """Forward, weight gradients, and input gradients where the input
    depends on a parameter."""
    return sum(f * (2 if kind in ("in", "mlp0") else 3) for kind, f in layers)


def generator_forward_flops(cfg: dict) -> float:
    """One image through G (the 14 DFBlock convs, the 1x1 shortcuts,
    to_rgb, `linear_in` and the affine MLPs)."""
    return _fwd(generator_layers(cfg))


def train_step_flops(cfg: dict) -> float:
    """One train step of `batch_size` images (`train/step.py`'s three
    phases, MA-GP every step):

    - G: one forward and its backward (weight and input gradients);
    - phase 1: D's embeds of the real and fake batch, its logits on
      2B + (B - 1) rows (real, fake, mismatched), weight and input
      gradients;
    - phase 2 (MA-GP): D on the real batch, the input gradient of its
      logits (every layer's input gradient), and the penalty's gradient
      with respect to D's weights through that input gradient: each
      layer's input-gradient product differentiated by its weight and by
      its output gradient. D's forward activations enter the input
      gradient only through LeakyReLU's masks, whose derivative is zero,
      so their backward is not needed: 4 forwards a layer;
    - phase 3: D's embeds and logits of the fakes and their input
      gradient (no weight gradient): 2 forwards a layer."""
    b = cfg["train"]["batch_size"]
    emb, logit = discriminator_layers(cfg)
    gen = _fwd_bwd(generator_layers(cfg))
    phase1 = 2 * _fwd_bwd(emb) + (3 * b - 1) / b * _fwd_bwd(logit)
    phase2 = 4 * (_fwd(emb) + _fwd(logit))
    phase3 = 2 * (_fwd(emb) + _fwd(logit))
    return b * (gen + phase1 + phase2 + phase3)


def k2_work(cfg: dict, batch: int) -> Dict[str, float]:
    """Operations, bytes and the least seconds of the 14 DFBlock
    modulated convs of one generator forward of `batch` images, each
    launch bounded on its own: each input byte read once (x, the four
    modulation vectors, the weights, the bias), each output byte written
    once."""
    esize = BYTES[cfg["precision"]]
    peak = peak_flops(cfg)
    flops = n_bytes = least = 0.0
    for r, ci, co in dfblock_shapes(cfg):
        f = 2.0 * batch * r * r * 9 * ci * co
        nb = (batch * r * r * ci + 4 * batch * ci + 9 * ci * co + co
              + batch * r * r * co) * esize
        flops += f
        n_bytes += nb
        least += bound_s(nb, f, peak)[0]
    return {"flops": flops, "bytes": n_bytes, "bound_s": least}


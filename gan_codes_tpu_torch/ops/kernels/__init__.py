"""Hand-written CUDA kernels for Hopper (sources in `gan_codes_tpu_torch/
csrc/`), each beside its plain PyTorch version and a launch counter.

  * `fused_affine.fused_double_affine_leaky` (K1)
  * `fused_modconv.fused_modconv3x3` (K2)
  * `fused_resblock.fused_resblock_g` (K3)

`COUNTERS` lists every counter of the ops layer as (holder, attribute):
the kernels' launches and MA-GP's weight terms (`nn.PenaltyConv2d`). A
new counter goes there, so that whatever replays captured work (the
train step's CUDA graphs) counts it as it counts the others.
"""
from .. import nn as _nn
from . import fused_affine, fused_modconv, fused_resblock

COUNTERS = ((fused_modconv.fused_modconv3x3, "launches"),
            (fused_affine.fused_double_affine_leaky, "launches"),
            (fused_affine.fused_double_affine_leaky_bwd, "launches"),
            (fused_resblock.fused_resblock_g, "launches"),
            (_nn.PenaltyConv2d, "weight_terms"))

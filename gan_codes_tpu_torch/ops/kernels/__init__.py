"""Hand-written CUDA kernels for Hopper (sources in `gan_codes_tpu_torch/
csrc/`), each beside its plain PyTorch version and a launch counter.

  * `fused_affine.fused_double_affine_leaky` (K1)
  * `fused_modconv.fused_modconv3x3` (K2)
  * `fused_resblock.fused_resblock_g` (K3)
"""

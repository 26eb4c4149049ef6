"""Tensor ops of the port: NHWC primitives, the DFBlock modulation and the
generator and discriminator residual blocks, with the hand-written CUDA
kernels under `ops/kernels/`."""

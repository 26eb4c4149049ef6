"""Tensor ops of the port: NHWC primitives, the DFBlock modulation and the
generator residual block, with the hand-written CUDA kernels under
`ops/kernels/`."""

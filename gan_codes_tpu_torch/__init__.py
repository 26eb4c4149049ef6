"""PyTorch / CUDA port of the Deep-Fusion-GAN framework, for one NVIDIA H100.

Serving (prompt -> text encoder -> generator -> 256px image) and the 3-phase
GAN train step, with every DFBlock of the generator running through
hand-written CUDA kernels (`ops/kernels/`, sources in `csrc/`), forward and
backward. It keeps the JAX package's layout and
module names, NHWC at its public functions, and the reference's state_dict
key names, so reference `gen_N.pth` / `text_encoder.pth` files load as-is.

Importing the package builds nothing and touches no device; entry points
run on CUDA unless the caller passes `device="cpu"`.
"""
__version__ = "0.1.0"

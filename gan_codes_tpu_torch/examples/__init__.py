"""Walkthroughs of the port (counterparts of the JAX package's
`examples/`, which mirror the reference's notebooks): `train_example`
trains on a synthetic CUB fixture and plots the curves, `eval_example`
samples from the trained weights. Run them as modules, e.g.
`python -m gan_codes_tpu_torch.examples.train_example`."""

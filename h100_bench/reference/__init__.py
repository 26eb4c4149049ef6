"""The plain reference: DF-GAN's text encoder, generator, discriminator,
train step and CUB data pipeline in plain PyTorch (`torch.nn.functional`)
and numpy / PIL, NCHW, on reference-named state_dicts. It imports nothing
of the port, and works out again whatever the port derives from the
harness's inputs."""

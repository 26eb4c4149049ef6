"""Training of the port: losses, the train state with its optimizers and
EMA, the 3-phase train step (data-parallel with a mesh), the trainer loop
and checkpointing (the port of `gan_codes_tpu/train/`)."""

"""Training of the port: losses, the train state with its optimizers and
EMA, and the 3-phase train step (the port of `gan_codes_tpu/train/`, without
the trainer loop and checkpointing yet)."""

"""Data parallelism of the port over `torch.distributed` (the port of
`gan_codes_tpu/parallel/`): `mesh.py`, the process group and its
collectives; `dp.py`, batch sharding and replication from rank 0. The
data-parallel step is `train.step.make_train_step(cfg, mesh)`."""

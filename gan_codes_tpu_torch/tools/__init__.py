"""Command-line tools of the port, each run as a module
(`python -m gan_codes_tpu_torch.tools.NAME`): `validate_pretrained` (the
FID-parity harness), `longrun` (kill-and-resume), `dp_check`, and the
kernel measurements `kernel_ab` (each kernel timed alone, across
checkouts) and `k3_plan_sweep` (K3's tilings, the source of its plan
model)."""

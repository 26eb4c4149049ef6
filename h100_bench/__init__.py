"""The benchmark of the PyTorch and CUDA port (`gan_codes_tpu_torch`) on
one NVIDIA H100: `python3 h100_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once and prints one JSON line.
See README.md."""

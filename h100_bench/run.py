"""Run one cell of the port's benchmark once on the machine it starts on.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and `checks`,
each number compared with the reference beside its limit) and the checks
as the last lines of standard error. Exits 2 without a result when CUDA
is missing or the machine holds fewer cards than the cell asks for.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "h100_bench", ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # fixed cache directories inside the checkout, before torch loads
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    from h100_bench import core, spec

    t_process = core.process_start()
    bench = spec.Spec(root=ROOT)
    chips = bench.cell(a.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {a.workload} needs {chips} CUDA card(s), "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}"
              f" with {torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    result = core.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           device="cuda", spec=bench, t_process=t_process)
    core.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

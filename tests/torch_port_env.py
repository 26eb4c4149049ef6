"""One compute thread for the port's tests, and for the processes they start.

Imported by every `tests/test_torch_port_*.py`. The suite runs under
several xdist workers on one host, and each worker's torch and numpy's
BLAS would otherwise start one thread per core: six workers then run
dozens of spinning compute threads on a few cores, and the port's small
CPU shapes spend most of their time waiting for each other. With one
thread per worker they run several times faster, with the same results
(each comparison is within one thread count: the tests' processes and the
children they start all run one thread).

Importing this module caps torch to one thread and, where `threadpoolctl`
is installed, numpy's BLAS too. The cap holds for the whole worker
process, so it also reaches tests of the JAX package that use torch or
numpy in the same worker. The autouse fixture `one_thread_children`, which
each port test module imports, sets OMP_NUM_THREADS and
OPENBLAS_NUM_THREADS to 1 for the module's tests, so every process they
start (the trainer's children, torchrun-style ranks, the tools) inherits
one thread.
"""
from __future__ import annotations

import pytest
import torch

CHILD_THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}

torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:  # numpy's BLAS keeps its own thread count
    BLAS_LIMITS = None
else:
    BLAS_LIMITS = threadpool_limits(1)


@pytest.fixture(autouse=True, scope="module")
def one_thread_children():
    """One compute thread in every process a test of the module starts."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in CHILD_THREADS.items():
            mp.setenv(name, value)
        yield

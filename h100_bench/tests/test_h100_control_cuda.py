"""The controls fail each cell's limits, read on a card at the cell's own
size on three seeds: the plain reference one precision below the
configuration's in the program's place, and for training the faults
planted in it (half the batch left out, the EMA's decay, G's learning
rate). Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider \
        h100_bench/tests/test_h100_control_cuda.py
"""
import pytest
import torch

from h100_bench import control, spec as spec_mod

SEEDS = [2**31 + 301, 2**31 + 302, 2**31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", spec_mod.Spec().cell_names())
def test_controls_fail_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls are read at full size")
    limits = spec_mod.Spec().cell_file(cell)["limits"]
    for seed, readings in control.run(cell, SEEDS):
        for kind, nums in readings.items():
            assert any(nums[k] > limits[k] for k in limits), (seed, kind,
                                                              nums)

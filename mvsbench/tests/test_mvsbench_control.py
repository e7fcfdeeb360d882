"""On the card, at each cell's own size: the program's numbers pass the
cell's limits and the lower-precision control (the fp8 reference in the
program's place) fails them, on three seeds."""
import pytest
import torch

from mvsbench import check, files
from mvsbench.calibrate import reading

CELLS = [w["name"] for w in files.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels)")
    cell = files.workload(name)
    got = reading(cell, seed, True, torch.device("cuda"))
    assert check.verdict(got["program"], cell["limits"]), got["program"]
    assert not check.verdict(got["control"], cell["limits"]), got["control"]

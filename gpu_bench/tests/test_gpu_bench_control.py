"""The control on the card at each cell's own size: the plain reference in
float8 in the program's place has to fail at least one of the cell's
limits, and a sound run of the program has to pass them. Needs a CUDA
device (marker ``gpu``); decides inside the test whether one is there."""

from __future__ import annotations

import pytest

from gpu_bench import harness
from gpu_bench.run import Ctx, run_cell

BENCH = harness.Bench()
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size on the card")
    ctx = Ctx(BENCH, cell, 2 ** 31 + 4242, 2.0, False,
              torch.device("cuda", 0), control=True)
    outcome = run_cell(ctx)
    limits = BENCH.limits(cell)
    control = ctx.readings["control"]
    assert outcome["correct"], outcome["checks"]
    assert any(control[k] > limits[k] for k in limits), control

"""A run with its timed path broken underneath comes out not correct: the
harness drives the rest of a run (on the CPU at a small width, past its
look for a card) over each fault the cell can have."""

from __future__ import annotations

import pytest

from gpu_bench.run import run_cell
from gpu_bench.tests import tiny


@pytest.mark.parametrize("cell, fault", [
    ("cnn.serve", "altered_answer"),
    ("cross.serve", "altered_answer"),
    ("cross.train", "unchanged_step"),
    ("cross.train", "half_batch"),
])
def test_fault_comes_out_not_correct(cell, fault):
    outcome = run_cell(tiny.ctx(cell, fault=fault))
    assert not outcome["correct"], outcome["checks"]


@pytest.mark.parametrize("cell", ["cross.serve", "cross.train"])
def test_control_reads_past_the_program(cell):
    """The control (the reference in float8 in the program's place) reads
    further from the reference than the float32 program does."""
    ctx = tiny.ctx(cell, control=True)
    run_cell(ctx)
    program, control = ctx.readings["program"], ctx.readings["control"]
    assert any(control[k] > 10 * program[k] for k in program)

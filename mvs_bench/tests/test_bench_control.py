"""The control (the plain reference computed in float8, the precision below
the configurations' bfloat16, put in the program's place) fails each cell's
comparison: at a small size on the CPU, and on the card at the cell's own
size (marked `cuda`)."""

import json
import math
from pathlib import Path

import pytest
import torch

from mvs_bench import calibrate, harness

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _fails(cell, numbers):
    return any(not math.isfinite(numbers[k]) or numbers[k] > v for k, v in cell.limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_small(name):
    cell = harness.Cell(SPEC, name)
    cell.op.update(height=128, width=160, max_d=16)
    cell.mix.update(pool=2)
    numbers = calibrate.control_numbers(cell, 2 ** 31 + 3, torch.device("cpu"))
    assert _fails(cell, numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_size(name, card):
    cell = harness.Cell(SPEC, name)
    numbers = calibrate.control_numbers(cell, 2 ** 31 + 4, card)
    assert _fails(cell, numbers), numbers

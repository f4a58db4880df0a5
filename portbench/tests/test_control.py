"""The control of `correct`: the plain reference put in the program's place
and computed in fp8, the precision below the configurations' bf16, and the
planted faults of a training step, must each fail one of the cell's
numbers: on the CPU at the tests' tiny size, and on the card at the cell's
own size (`gpu`)."""

from __future__ import annotations

import pytest

from portbench.harness import manifest
from portbench.tests import tiny
from portbench.tools import readings

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[n] for n, v in numbers.items())


def _check(cell: dict, device: str, seed: int) -> None:
    if cell["mix"]["driver"] == "train":
        got = readings.train_controls(cell, seed, device)
    else:
        got = {"control fp8": readings.search_control(cell, seed, device)}
    for name, numbers in got.items():
        assert _fails(numbers, cell["limits"]), (name, numbers, cell["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_cpu(cell):
    """A training cell at the tests' tiny size; a search cell at its own
    model, beams and catalog, on short prompts (the control's error grows
    with depth and width, and the reference alone runs here)."""
    if ".search." in cell:
        c = manifest.cell(cell)
        c["mix"].update(max_blocks=6, pool=4 * c["mix"]["batch"])
        c["check_requests"] = 3
    else:
        c = tiny.cell(cell)
    _check(c, "cpu", 2 ** 31 + 5)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cell, card):
    _check(manifest.cell(cell), card, 2 ** 31 + 5)

"""Each driver at a tiny size on the CPU, through the port's plain paths:
a well-formed result line, the port in agreement with the reference, and
`correct` false when the timed path is broken underneath."""

from __future__ import annotations

import json

import pytest

from portbench import run
from portbench.harness import manifest
from portbench.tests import tiny
from portbench.tools import faults

BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def execute(name: str, traced: bool = False, seed: int = 2 ** 31 + 11) -> dict:
    return run.execute(tiny.cell(name), seed, 0.3, traced, "cpu", BENCH)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, traced):
    res = json.loads(json.dumps(execute(cell, traced)))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = (manifest.per_layer(BENCH, cell) if traced else manifest.end_to_end(BENCH, cell))
    names = {m["name"] for m in want}
    assert set(res["metrics"]) <= names and res["metrics"]
    if not traced:
        assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(cell):
    """At fp32 on the CPU the port's plain paths and the reference agree to
    rounding: far under any limit set for bf16 on the card."""
    checks = execute(cell)["checks"]
    for name, c in checks.items():
        assert c["value"] <= (0 if name in ("batch_mismatch", "invalid_answers") else 1e-4), checks


@pytest.mark.parametrize("fault", faults.TRAIN)
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train." in c])
def test_train_fault_is_not_correct(cell, fault, monkeypatch):
    faults.plant("train", fault, monkeypatch.setattr)
    res = execute(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", faults.SEARCH)
@pytest.mark.parametrize("cell", [c for c in CELLS if ".search." in c])
def test_search_fault_is_not_correct(cell, fault, monkeypatch):
    faults.plant("search", fault, monkeypatch.setattr)
    res = execute(cell)
    assert res["correct"] is False, res["checks"]
    if fault == "suboptimal beams":  # caught by the selection, not the scores
        assert res["checks"]["best_gap"]["value"] > res["checks"]["best_gap"]["limit"]
        assert res["checks"]["score_gap"]["value"] <= res["checks"]["score_gap"]["limit"]

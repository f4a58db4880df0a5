"""The trace's readings on a made-up timeline: the idle share inside the
steps counts the gaps between a step's operations and leaves out the host's
time between steps; the window runs from the first operation to the last."""

from __future__ import annotations

import pytest

from portbench.harness.trace import Trace


def _trace() -> Trace:
    # two steps, host spans at 0 and 100; step 1: ops 10-20 and 25-40 (a gap
    # of 5 inside it, an overlap counted once); step 2: ops 120-150
    ops = [("k", 10.0, 20.0), ("k", 12.0, 18.0), ("k", 25.0, 40.0), ("k", 120.0, 150.0)]
    spans = [("search", 0.0, 45.0), ("search", 100.0, 155.0)]
    return Trace(ops, spans, 2)


def test_step_idle_counts_gaps_inside_steps_only():
    assert _trace().step_idle("search") == pytest.approx(1 - (10 + 15 + 30) / (30 + 30))


def test_step_idle_without_its_spans_reads_nothing():
    assert _trace().step_idle("train_step") is None


def test_window_and_busy():
    tr = _trace()
    assert tr.window_s == pytest.approx(140e-6)
    assert tr.busy_s == pytest.approx(55e-6)
    gaps = tr.breakdown()["idle_gaps"]
    assert [g[0] for g in gaps] == ["search", "search"]
    assert gaps[0][1] == pytest.approx(80e-6) and gaps[1][1] == pytest.approx(5e-6)

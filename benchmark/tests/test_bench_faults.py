"""`correct` comes out false under the control and under each fault a cell
can have, with the harness's look for a card skipped and the rest of a run
driven at a small size on the CPU."""

from __future__ import annotations

import pytest

from benchmark import faults, run
from benchmark.tests import tiny

CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = tiny.run_tiny(cell, seed=2**31 + 3, control=True)
    limits = {k: c["limit"] for k, c in line["checks"].items()}
    assert line["correct"]
    assert any(v > limits[k] for k, v in line["control"].items()), line["control"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in sorted(faults.FAULTS)
    if run.cell_spec(c).traffic["loop"] in faults.FAULTS[f].loops])
def test_fault_is_not_correct(cell, fault):
    line = tiny.run_tiny(cell, seed=2**31 + 4, seconds=0.2, fault=faults.FAULTS[fault]())
    assert not line["correct"], line["checks"]

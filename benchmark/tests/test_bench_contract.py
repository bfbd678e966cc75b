"""BENCHMARK.json against the benchmark's contract, the files each cell is
found by, the result line's keys, and a run without a card."""

from __future__ import annotations

import io
import json
import os
import re
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            if "bound" in e:
                assert 0.01 <= e["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        # each cell a per-layer metric lists reports the metric it moves
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", moved)) <= set(moved), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = run.cell_spec(cell)
    assert spec.chips == 1
    assert os.path.exists(os.path.join(run.HERE, "loops", spec.traffic["loop"] + ".py"))
    assert set(spec.limits) >= {"obs_gap", "rew_gap", "done_mismatch", "state_gap", "reset_gap"}
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"} and len(spec.end_to_end) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        read = run.reader(m["name"])
        # a reader with nothing to read returns nothing, never 0
        assert read(SimpleNamespace(device_trace=None, spans=None, learner_ms={},
                                    traced_rate=None, stretch_steps=0, num_envs=8,
                                    config=spec.config)) is None


def test_config_files_hold_the_frozen_counts():
    for c in BENCH["configs"]:
        cfg = run.load_json(run.ROOT, c["file"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for k in ("flops_per_env_step", "bytes_per_env_step", "learner_flops_per_sample"):
            assert cfg[k] > 0 and k in cfg["derived"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    line = tiny.run_tiny("box_stacking.step", seed=2**31 + 5, seconds=0.3, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    if not trace:
        assert set(line["metrics"]) == {"env_steps_per_s.two_box", "step_ms_p95.two_box",
                                        "setup_s"}
    else:
        # no device metric from a CPU run
        assert line["metrics"] == {}


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "steady_host", lambda: None)  # keep the test worker unpinned
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    line = run.run_cell(cell, 2**31 + 17, 2.0, False)
    assert line["correct"] and line["device"]["platform"] == "gpu"

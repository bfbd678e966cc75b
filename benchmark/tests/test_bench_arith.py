"""The benchmark's arithmetic against numbers worked out by hand."""

from __future__ import annotations

import math

import pytest

from benchmark import run, stats
from benchmark.trace import DeviceTrace


def test_percentile():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)   # 4 + 0.8 * (5 - 4)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_union_and_idle_from_intervals():
    ivs = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert stats.union_length(ivs) == 26          # [0,15] + [20,31]
    assert stats.idle_share(ivs, 50) == pytest.approx(48.0)
    assert stats.idle_gaps(ivs, 0, 50) == [(15, 20), (31, 40), (40, 50)]


def test_device_trace_busy_idle_and_gaps():
    ops = [("k1", "kernel", 100, 300), ("add", "kernel", 250, 400), ("k1", "kernel", 600, 900)]
    anns = [("bench.step_fn", 350, 700)]
    t = DeviceTrace(ops, anns, (0, 1000))
    assert t.busy_s == pytest.approx(600e-9)      # [100,400] + [600,900]
    assert t.idle_pct() == pytest.approx(40.0)
    # the gap [400,600] began inside bench.step_fn; [0,100] and [900,1000] outside it
    assert dict(t.top_gaps()) == {"bench.step_fn": pytest.approx(200e-9),
                                  "outside the spans": pytest.approx(200e-9)}
    assert t.top_ops()[0] == ["k1", pytest.approx(500e-9)]


def test_roofline_share():
    # 67 GFLOP at 67 TFLOP/s is 1 ms; 1 GB at 3.35 TB/s is 0.2985 ms: bound 1 ms
    assert stats.roofline_share(67e9, 1e9, 4e-3) == pytest.approx(25.0)
    # bytes bind: 6.7 GB is 2 ms
    assert stats.roofline_share(1e9, 6.7e9, 4e-3) == pytest.approx(50.0)


def test_f32_mfu():
    # 1,000,000 FLOPs x 3,350,000 per s = 3.35 TFLOP/s = 5% of 67
    assert stats.f32_mfu(1e6, 3.35e6) == pytest.approx(5.0)


def test_learner_flops_recomputed_from_the_config_widths():
    for name in ("blind_grasping_curriculum", "box_stacking"):
        c = run.load_json(run.HERE, "configs", name + ".json")
        s = c["shapes"]
        assert stats.learner_flops_per_sample(
            s["num_obs"], s["num_states"], s["num_actions"], s["units"],
            s["mini_epochs"]) == c["learner_flops_per_sample"]
    # by hand: actor 158-512-256-128-18 and critic 135-512-256-128-1
    macs = (158 * 512 + 512 * 256 + 256 * 128 + 128 * 18) + (135 * 512 + 512 * 256 + 256 * 128
                                                             + 128 * 1)
    assert macs == 480128
    assert stats.learner_flops_per_sample(158, 135, 18, (512, 256, 128), 4) == 2 * macs * 13


def test_worst_leaf_gap():
    ref = {"a": 1.0, "b": 2.0, "c": 0.001}
    prog = {"a": 1.1, "b": 2.0, "c": 0.002}
    # c's gap 0.001 is held against the median leaf (1.0), not its own norm
    assert stats.worst_leaf_gap(prog, ref) == (pytest.approx(0.1), "a")
    assert math.isclose(stats.worst_leaf_gap(ref, ref)[0], 0.0)


"""The port's tools on the CPU: `tools/diag_rollout.py` (a checkpoint's
policy on the unfused step, terminations by criterion, task-state
summaries) and `tools/dexhand_test.py` (the environment harness: the
action-to-DOF checks, the sweep, `mode=contact`, `mode=rulebased` with a
policy that controls nothing, and each graphics option: `videoRecord`,
`plot`, `live`).
"""

import dataclasses
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch.envs import action as action_mod
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.rl.checkpoint import save_checkpoint
from dexrobot_isaac_tpu_torch.rl.ppo import PPOLearner, ppo_config_from
from dexrobot_isaac_tpu_torch.tools import dexhand_test, diag_rollout
from dexrobot_isaac_tpu_torch.utils.config import load_config

CHEAP = ["sim.substeps=1"]


def _run_dir_with_checkpoint(root, task):
    """A run directory as the CLI writes it (`config.json`, `nn/latest.pt`)
    for `task` at 8 envs, episodes of 4 steps and a small network."""
    cfg = load_config([f"task={task}", "numEnvs=8", "env.episodeLength=4",
                       "train.params.network.units=[32,32]"] + CHEAP)
    env = make_env(cfg, device="cpu")
    learner = PPOLearner(ppo_config_from(cfg, env), env.step_fn, seed=1, device="cpu")
    run = root / f"{task}_train"
    os.makedirs(run / "nn")
    with open(run / "config.json", "w") as f:
        json.dump(cfg, f)
    save_checkpoint(str(run / "nn" / "latest.pt"), learner.init_state(), {"iteration": 1},
                    learner)
    return str(run / "nn" / "latest.pt")


@pytest.mark.parametrize("task", ["BlindGrasping", "BoxStacking"])
def test_diag_rollout_counts_terminations(tmp_path, capsys, task):
    path = _run_dir_with_checkpoint(tmp_path, task)
    counts = diag_rollout.run(path, "BaseTask", 1.0, 8, 9, "cpu")
    out = capsys.readouterr().out
    assert "using run config" in out and f"task={task}" in out
    assert counts["episodes"] >= 8 * 2  # the saved config's 4-step episodes
    reasons = [k for k in counts if k.startswith(("success_reason_", "failure_reason_"))]
    assert any(k.startswith("failure_reason_") for k in reasons)
    assert sum(counts[k] for k in reasons) <= counts["episodes"]
    assert f"episodes finished: {counts['episodes']}" in out
    if task == "BoxStacking":
        assert "closest stack distance" in out


def test_diag_rollout_cli_usage(capsys):
    assert diag_rollout.main([]) == 2
    assert "diag_rollout" in capsys.readouterr().out


@pytest.fixture(scope="module")
def pipeline():
    env = make_env(load_config(["task=BlindGrasping", "numEnvs=2"]), device="cpu")
    return env.comps.pipeline


@pytest.mark.parametrize("mode", ["position", "position_delta"])
def test_action_mapping_verified(pipeline, mode):
    pl = dataclasses.replace(pipeline, control_mode=mode)
    assert dexhand_test.verify_action_mapping(pl, 18, True, True) == []
    assert dexhand_test.verify_custom_rule_modes(pipeline, 18) == []


def test_corrupted_coupling_is_caught(pipeline):
    src = pipeline.coupling_src.copy()
    src[[10, 14]] = src[[14, 10]]
    bad = dataclasses.replace(pipeline, coupling_src=src)
    failures = dexhand_test.verify_action_mapping(bad, 18, True, True)
    assert any("cross-talk" in f for f in failures)


def test_zero_actions_keep_the_rule_targets(pipeline):
    """A policy that controls nothing: (N, 0) actions, the rule's targets
    through the filters."""
    pl = dataclasses.replace(pipeline, policy_controls_base=False,
                             policy_controls_fingers=False, num_actions=0)
    prev = torch.zeros(3, 18)
    rule = prev + 0.001
    full, active = action_mod.process_actions(pl, torch.zeros(3, 0), prev, rule)
    torch.testing.assert_close(active, rule)
    assert full.shape == (3, 26)


def test_harness_sweep(capsys):
    assert dexhand_test.main(["task=BaseTask", "device=cpu", "steps=6"] + CHEAP) == 0


def test_harness_contact_mode():
    assert dexhand_test.main(["mode=contact", "device=cpu", "steps=1"] + CHEAP) == 0


def test_harness_rule_based_mode():
    """0 policy actions; the rule moves the base."""
    assert dexhand_test.main(["mode=rulebased", "task=BlindGrasping", "device=cpu",
                              "steps=1"] + CHEAP) == 0
    name = dexhand_test.rule_based_task("BlindGrasping")
    env = make_env(dexhand_test.rule_based_config(load_config(
        ["task=BlindGrasping", "numEnvs=2"] + CHEAP)), device="cpu")
    assert env.num_actions == 0 and env.comps.task.pre_action_rule is not None
    assert name == "BlindGraspingRuleBased"
    env.reset()
    x0 = env.state.physics.q[:, 0].clone()
    for _ in range(10):
        env.step(torch.zeros(2, 0))
    assert float((env.state.physics.q[:, 0] - x0).abs().max()) > 1e-4
    assert np.isfinite(env.state.physics.q.numpy()).all()


@pytest.mark.parametrize("option", ["videoRecord=true", "plot=true", "live=true",
                                    "env.videoRecord=true"])
def test_harness_graphics_option_runs(option, tmp_path, monkeypatch):
    """Each graphics option of the sweep writes what it promises: the mp4,
    the PNG, the live series (read through /data before the server stops).
    The action-mapping checks before the sweep are held above."""
    from dexrobot_isaac_tpu_torch.graphics.liveplot import LivePlotServer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dexhand_test, "verify_action_mapping", lambda *a, **k: [])
    monkeypatch.setattr(dexhand_test, "verify_custom_rule_modes", lambda *a, **k: [])
    stop, data = LivePlotServer.stop, {}

    def stop_reading_data(srv):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/data", timeout=5) as r:
            data.update(json.loads(r.read()))
        stop(srv)

    monkeypatch.setattr(LivePlotServer, "stop", stop_reading_data)
    assert dexhand_test.main([option, "device=cpu", "task=BaseTask", "steps=6",
                              "sim.physics_steps_per_control=1"] + CHEAP) == 0
    made = sorted(os.listdir(tmp_path))
    if option == "plot=true":
        assert made == ["dexhand_test_series.png"]
        assert os.path.getsize(tmp_path / "dexhand_test_series.png") > 1000
    elif option == "live=true":
        assert made == [] and len(data["reward (env 0)"]) == 18 * 6
        assert len(data["q[0] sweep DOF"]) == 6 and len(data["contacts (env 0)"]) == 18 * 6
    else:
        assert made == ["dexhand_test_videos"]
        assert os.path.getsize(tmp_path / "dexhand_test_videos" / "episode_00001.mp4") > 1000

"""The port's CLI (`python -m dexrobot_isaac_tpu_torch.train`) end to end on
the CPU: train -> checkpoints -> resume (curriculum difficulty restored) ->
evaluate, the Coriolis path with the unfused step, the fused step's plain
version, `train.profile`, and training with the graphics keys set (read
only in evaluation). Tiny shapes: BlindGrasping at 4 envs, one physics
substep per control step, a [32, 32] network, horizon 4.
"""

import json
import os

import pytest
import torch

from dexrobot_isaac_tpu_torch import train as cli
from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
from dexrobot_isaac_tpu_torch.rl.checkpoint import load_checkpoint_meta
from dexrobot_isaac_tpu_torch.utils.config import load_config

BASE_ARGS = [
    "device=cpu", "task=BlindGrasping", "numEnvs=4", "env.episodeLength=8",
    "sim.substeps=1", "sim.physics_steps_per_control=1",
    "train.logging.noLogFile=true",
    "train.params.config.save_frequency=2",
    "train.params.network.units=[32,32]",
    "train.params.config.horizon_length=4",
    "train.params.config.minibatch_size=8",
    "train.params.config.mini_epochs=1",
]
CURRICULUM = ["task.curriculum.enabled=true",
              # a promotion threshold above 1: the difficulty never moves
              "task.curriculum.promote_success_rate=2.0"]


@pytest.fixture(scope="module")
def runs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_runs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEXHAND_RUNS_DIR", d)
        yield d


def _latest_meta(runs_dir):
    runs_all = os.path.join(runs_dir, "runs_all")
    run = sorted(n for n in os.listdir(runs_all) if "_train_" in n)[-1]
    return os.listdir(os.path.join(runs_all, run, "nn")), load_checkpoint_meta(
        os.path.join(runs_all, run, "nn", "latest.pt"))


def test_train_checkpoints_and_resume_restores_difficulty(runs_dir):
    assert cli.main(BASE_ARGS + CURRICULUM + [
        "maxIterations=2", "task.curriculum.initial_difficulty=0.55"]) == 0
    files, meta = _latest_meta(runs_dir)
    assert {"BlindGrasping_ep2.pt", "latest.pt", "BlindGrasping_best.pt"} <= set(files)
    assert meta["iteration"] == 2 and abs(meta["difficulty"] - 0.55) < 1e-9
    # resume with another initial difficulty: the saved one wins
    s = cli.build(load_config(BASE_ARGS + CURRICULUM + [
        "maxIterations=1", "checkpoint=latest", "task.curriculum.initial_difficulty=0.1"]))
    assert s.resume_meta["difficulty"] == pytest.approx(0.55)
    assert cli.run_train(s) == 0
    _, meta2 = _latest_meta(runs_dir)
    assert abs(meta2["difficulty"] - 0.55) < 1e-9
    assert int(s.ppo.epoch) == 3  # 2 saved iterations + 1 resumed
    assert s.stats and s.stats[-1]["rollout_s"] > 0


def test_eval_from_checkpoint(runs_dir):
    s = cli.build(load_config(BASE_ARGS + CURRICULUM + [
        "test=true", "checkpoint=latest", "testGamesNum=4",
        "task.curriculum.initial_difficulty=0.2"]))
    assert s.test_mode and s.fused is None
    assert cli.run_test(s) == 0
    assert s.env.comps.initial_difficulty == 1.0  # eval runs the full distribution
    assert s.stats[-1]["episodes"] >= 4


def test_coriolis_iteration_runs_unfused(runs_dir):
    s = cli.build(load_config(BASE_ARGS + [
        "maxIterations=1", "sim.coriolis=true", "train.params.config.fused=off"]))
    assert s.env.comps.engine.params.coriolis and s.fused is None
    assert cli.run_train(s) == 0
    assert all(torch.isfinite(v).all() for v in s.ppo.params.values())


def test_fused_on_runs_the_plain_fused_step_on_cpu(runs_dir):
    s = cli.build(load_config(BASE_ARGS + ["maxIterations=1", "train.params.config.fused=on"]))
    assert s.fused is not None and s.learner.comp_names == s.fused.comp_names
    assert cli.run_train(s) == 0
    with pytest.raises(FusedUnsupported, match="coriolis"):
        cli.build(load_config(BASE_ARGS + ["sim.coriolis=true", "train.params.config.fused=on"]))


@pytest.mark.parametrize("option", ["env.videoRecord=true", "env.viewer=true",
                                    "env.videoStream=true"])
def test_graphics_options_train_without_the_sidecar(runs_dir, option):
    """Training reads none of the graphics keys (JAX reads them only in
    evaluation): it trains, and records and serves nothing."""
    s = cli.build(load_config(BASE_ARGS + ["maxIterations=1", "env.stream.port=18470", option]))
    assert cli.run_train(s) == 0
    assert "videos" not in os.listdir(s.run_dir)
    assert "latest.pt" in os.listdir(os.path.join(s.run_dir, "nn"))


def test_profile_writes_a_trace(runs_dir):
    """`train.profile=1` traces iteration 2 with torch.profiler into
    `<run_dir>/profile/trace.json` (a Chrome trace of the CPU ops here)."""
    s = cli.build(load_config(BASE_ARGS + ["maxIterations=3", "train.profile=1"]))
    assert cli.run_train(s) == 0
    path = os.path.join(s.run_dir, "profile", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_help(capsys):
    assert cli.main(["--help"]) == 0
    assert "device=cpu" in capsys.readouterr().out

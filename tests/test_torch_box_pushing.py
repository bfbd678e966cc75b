"""The port's BoxPushing env step held against the JAX package (CPU).

A light config (8 envs, 2 physics steps of 1 substep per control step,
episodeLength 3 so an auto-reset fires) runs `reset_fn` and three `step_fn`
steps in the JAX package; the port replays them from its own reset and from
the JAX state carried over by convert.py, with the JAX step's reset samples
(the sampled `target_xy` and distances reach the step, and the fused step's
reset rows, as operands): done exact, obs atol 2e-4, reward and each
component atol 1e-3 (tests/test_golden_trajectory.py). The same with the
curriculum on (the target distance scaled by the difficulty). Also: the
fused layout, the plain fused step against the unfused step bit for bit,
and the distribution of the port's own `reset_task` sampler.
"""

import math

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch.envs.tasks.box_pushing import BoxPushingTask
from dexrobot_isaac_tpu_torch.envs.tasks.box_reorientation import _box_yaw
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_parity as tp

LIGHT = ["task=BoxPushing", "numEnvs=8", "env.episodeLength=3", "sim.substeps=1",
         "sim.physics_steps_per_control=2"]
CONFIGS = {"task": LIGHT,
           "curriculum": LIGHT + ["task.curriculum.enabled=true",
                                  "task.curriculum.initial_difficulty=0.3"]}
SEED, STEPS = 5, 3


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    config = CONFIGS[request.param]
    run = tp.jax_rollout(config, SEED, STEPS)
    env = make_env(load_config(config), seed=SEED, device="cpu")
    return request.param, env, run, tp.port_runs(env, run)


def test_reset_obs_matches_jax(case):
    _, _, run, port = case
    np.testing.assert_allclose(port["reset_obs"], run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_matches_jax(case, start, t):
    _, _, run, port = case
    tp.assert_step_matches(port[start], run, t)


def test_fused_layout_matches_jax(case):
    _, env, run, _ = case
    fused = env.make_fused()
    assert fused.build == "fused_step_pushing" and fused.rst_rows == 26 + 7 + 5
    assert fused.rts_keys == ["hold_duration_steps", "initial_dist", "prev_dist", "target_xy"]
    tp.assert_layout_matches(fused, run)


def test_plain_fused_step_equals_unfused_step(case):
    _, env, run, _ = case
    t = int(np.argmax([d.any() for d in run["done"]]))  # a step with a reset
    assert bool(tp.assert_fused_equals_unfused(env, run, t).any())


# ---------------------------------------------------------------- the sampler
@pytest.mark.parametrize("curriculum,difficulty", [(False, 0.0), (True, 0.0), (True, 0.5)])
def test_reset_sampler_distribution(curriculum, difficulty):
    cfg = load_config(["task=BoxPushing"])["task"]
    cfg["curriculum"] = {"enabled": curriculum, "min_fraction": 0.4}
    task = BoxPushingTask(cfg)
    gen = torch.Generator().manual_seed(0)
    n = 20000
    r = task.reset_task(gen, n, torch.zeros(26), difficulty=torch.tensor(difficulty))
    assert bool((r.box_pos[:, :2].abs() <= task.box_xy_range).all())
    assert bool((r.box_pos[:, 2] == task.box_z).all())
    assert float(_box_yaw(r.box_quat).abs().max()) <= math.pi
    scale = 0.4 + 0.6 * difficulty if curriculum else 1.0
    lo, hi = task.target_dist_min * scale, task.target_dist_max * scale
    ts = r.task_states
    dist = torch.linalg.vector_norm(ts["target_xy"] - r.box_pos[:, :2], dim=-1)
    assert float(dist.min()) >= lo - 1e-6 and float(dist.max()) <= hi + 1e-6
    assert abs(float(dist.mean()) - (lo + hi) / 2) < 0.002
    ang = torch.atan2(*(ts["target_xy"] - r.box_pos[:, :2]).unbind(-1)[::-1])
    assert abs(float(ang.mean())) < 0.05 and abs(float(ang.abs().mean()) - math.pi / 2) < 0.05
    torch.testing.assert_close(ts["initial_dist"], dist)
    assert torch.equal(ts["prev_dist"], ts["initial_dist"])
    assert bool((ts["hold_duration_steps"] == 0).all())
    assert bool((r.dof_pos[:, 0:3].abs() <= task.hand_translation_range).all())
    assert bool((r.dof_pos[:, 6:] <= task.finger_range).all())

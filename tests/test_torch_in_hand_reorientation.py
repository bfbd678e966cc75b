"""The port's InHandReorientation env step held against the JAX package (CPU).

The box starts pinched in mid-air (the build-time pinch solve), so contacts
are active from the first step. A light config (8 envs, 2 physics steps of
1 substep per control step, episodeLength 3 so an auto-reset fires) runs
`reset_fn` and three `step_fn` steps in the JAX package; the port replays
them from its own reset and from the JAX state carried over by convert.py,
with the JAX step's reset samples: done exact, obs atol 2e-4, reward and each
component atol 1e-3 (tests/test_golden_trajectory.py). The same for
`experiments=InHandFingersOnly` (`policy_controls_hand_base: false`: 12
actions, the base held at its previous target by the default pre-action
rule). Also: the pinch solve against the JAX one (grip q and box pose to
1e-5), the fused layout, the plain fused step against the unfused step bit
for bit, and the port's reset sampler.
"""

import math

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu.envs.tasks.in_hand_reorientation import _solve_pinch as jax_solve_pinch
from dexrobot_isaac_tpu.models.dexhand021 import build_hand_model as jax_hand_model
from dexrobot_isaac_tpu_torch.envs.tasks.api import symmetric_angle_error
from dexrobot_isaac_tpu_torch.envs.tasks.box_reorientation import _box_yaw
from dexrobot_isaac_tpu_torch.envs.tasks.in_hand_reorientation import (
    InHandReorientationTask,
    _solve_pinch,
)
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.models.dexhand021 import build_hand_model
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_parity as tp

LIGHT = ["numEnvs=8", "env.episodeLength=3", "sim.substeps=1", "sim.physics_steps_per_control=2"]
CONFIGS = {"task": ["task=InHandReorientation"] + LIGHT,
           "fingers_only": ["experiments=InHandFingersOnly"] + LIGHT}
SEED, STEPS = 5, 3


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    config = CONFIGS[request.param]
    run = tp.jax_rollout(config, SEED, STEPS)
    env = make_env(load_config(config), seed=SEED, device="cpu")
    return request.param, env, run, tp.port_runs(env, run)


def test_scene(case):
    name, env, _, _ = case
    p, task = env.comps.engine.params, env.comps.task
    assert p.has_box and not p.has_box2
    np.testing.assert_array_equal(task.hand_spawn, [0.0, 0.0, 0.25])
    assert env.num_actions == (12 if name == "fingers_only" else 18)
    assert env.comps.pipeline.policy_controls_base == (name != "fingers_only")


def test_reset_obs_matches_jax(case):
    _, _, run, port = case
    np.testing.assert_allclose(port["reset_obs"], run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_matches_jax(case, start, t):
    _, _, run, port = case
    tp.assert_step_matches(port[start], run, t)


def test_contacts_active_from_the_first_step(case):
    """The pinched box: after the first step (random actions) the thumb tip
    carries contact force in every env, and the index or middle tip in most,
    in the JAX state and in the port's replay of that step."""
    _, env, run, _ = case
    m = env.comps.model
    tips = [m.body_index(f"r_f_link{f}_4") for f in (1, 2, 3)]
    state = tp.convert.env_state(run["states"][0], "cpu")
    new, *_ = env.step_fn(state, tp.T(run["actions"][0]), samples=tp.samples_at(run, 0))
    for force in (np.asarray(run["states"][1].body_contact_force), new.body_contact_force.numpy()):
        mag = np.linalg.norm(force[:, tips], axis=-1)
        assert bool((mag[:, 0] > 0).all()) and (mag[:, 1:].max(1) > 0).mean() >= 0.5


def test_fused_layout_matches_jax(case):
    _, env, run, _ = case
    fused = env.make_fused()
    assert fused.build == "fused_step_inhand" and fused.rst_rows == 26 + 7 + 3
    tp.assert_layout_matches(fused, run)


def test_plain_fused_step_equals_unfused_step(case):
    _, env, run, _ = case
    t = int(np.argmax([d.any() for d in run["done"]]))  # a step with a reset
    assert bool(tp.assert_fused_equals_unfused(env, run, t).any())


@pytest.mark.parametrize("box_size,penetration", [(0.05, 0.0015), (0.055, 0.001)])
def test_solve_pinch_matches_jax(box_size, penetration):
    got = _solve_pinch(build_hand_model(), box_size, penetration)
    want = jax_solve_pinch(jax_hand_model(), box_size, penetration)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_solve_pinch_refuses_what_jax_refuses():
    """A 4 cm box is too small for the tips to close on: both solves raise."""
    with pytest.raises(ValueError, match="pinch solve failed"):
        jax_solve_pinch(jax_hand_model(), 0.04, 0.001)
    with pytest.raises(ValueError, match="pinch solve failed"):
        _solve_pinch(build_hand_model(), 0.04, 0.001)


# ---------------------------------------------------------------- the sampler
@pytest.mark.parametrize("curriculum", [False, True])
def test_reset_sampler_distribution(curriculum):
    cfg = load_config(["task=InHandReorientation"])["task"]
    cfg["curriculum"] = {"enabled": curriculum, "min_range_fraction": 0.3}
    task = InHandReorientationTask(cfg)
    gen = torch.Generator().manual_seed(0)
    n, d = 20000, 0.5
    r = task.reset_task(gen, n, torch.zeros(26), difficulty=torch.tensor(d))
    for got, want in ((r.dof_pos, task.grip_q), (r.box_pos, task.box_center0),
                      (r.box_quat, task.box_quat0)):
        assert torch.equal(got, torch.as_tensor(want).expand(n, -1))
    assert task.hang_z == pytest.approx(0.25 + float(task.box_center0[2] - 0.25))
    yaw0 = _box_yaw(r.box_quat)
    off = r.task_states["target_yaw"] - yaw0
    scale = 0.3 + 0.7 * d if curriculum else 1.0
    lo, hi = task.min_initial_error * scale, task.period / 2 * scale
    assert float(off.abs().min()) >= lo - 1e-5 and float(off.abs().max()) <= hi + 1e-5
    assert abs(float(off.abs().mean()) - (lo + hi) / 2) < 0.005
    assert abs(float((off > 0).float().mean()) - 0.5) < 0.02
    torch.testing.assert_close(r.task_states["prev_yaw_error"],
                               symmetric_angle_error(yaw0, r.task_states["target_yaw"],
                                                     task.period))
    assert bool((r.task_states["aligned_duration_steps"] == 0).all())
    assert math.isfinite(task.hang_z) and task.hang_z < 0.25

"""The port's BoxReorientation env step held against the JAX package (CPU).

A light config (8 envs, 2 physics steps of 1 substep per control step,
episodeLength 3 so an auto-reset fires) runs `reset_fn` and three `step_fn`
steps in the JAX package; the port replays them from its own reset and from
the JAX state carried over by convert.py, with the JAX step's reset samples,
at the tolerances of tests/test_golden_trajectory.py: done exact, obs atol
2e-4, reward and each component atol 1e-3. Also: the fused layout against
the JAX package's, the plain fused step against the unfused step bit for
bit, the symmetric yaw error against the JAX one (half-way cases round to
even), and the distribution of the port's own `reset_task` sampler.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dexrobot_isaac_tpu.envs.tasks.api import symmetric_angle_error as jax_sym_err
from dexrobot_isaac_tpu.envs.tasks.box_reorientation import _box_yaw as jax_box_yaw
from dexrobot_isaac_tpu_torch.envs.tasks.api import symmetric_angle_error
from dexrobot_isaac_tpu_torch.envs.tasks.box_reorientation import BoxReorientationTask, _box_yaw
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_parity as tp

CONFIG = ["task=BoxReorientation", "numEnvs=8", "env.episodeLength=3", "sim.substeps=1",
          "sim.physics_steps_per_control=2"]
SEED, STEPS = 5, 3


@pytest.fixture(scope="module")
def jax_run():
    return tp.jax_rollout(CONFIG, SEED, STEPS)


@pytest.fixture(scope="module")
def port_env():
    return make_env(load_config(CONFIG), seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def port_runs(port_env, jax_run):
    return tp.port_runs(port_env, jax_run)


def test_reset_obs_matches_jax(port_runs, jax_run):
    np.testing.assert_allclose(port_runs["reset_obs"], jax_run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_matches_jax(port_runs, jax_run, start, t):
    tp.assert_step_matches(port_runs[start], jax_run, t)


def test_fused_layout_matches_jax(port_env, jax_run):
    fused = port_env.make_fused()
    assert fused.build == "fused_step_reorient" and fused.rst_rows == 26 + 7 + 6
    tp.assert_layout_matches(fused, jax_run)


def test_plain_fused_step_equals_unfused_step(port_env, jax_run):
    t = int(np.argmax([d.any() for d in jax_run["done"]]))  # a step with a reset
    assert bool(tp.assert_fused_equals_unfused(port_env, jax_run, t).any())


def test_symmetric_angle_error_matches_jax():
    """Half-way errors round to even in both (jnp.round, torch.round), so
    +-pi/4 on a quarter-turn period keep their sign as JAX keeps it."""
    period = math.pi / 2
    e = np.array([-3 * period / 2, -period / 2, -0.3, 0.0, 0.3, period / 2, 3 * period / 2,
                  2.9, -2.9], np.float32)
    tgt = np.zeros_like(e)
    want = np.asarray(jax_sym_err(jnp.asarray(e), jnp.asarray(tgt), period))
    got = symmetric_angle_error(torch.as_tensor(e), torch.as_tensor(tgt), period).numpy()
    np.testing.assert_array_equal(got, want)
    q = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(_box_yaw(torch.as_tensor(q)).numpy(),
                               np.asarray(jax_box_yaw(jnp.asarray(q))), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- the sampler
def test_reset_sampler_distribution():
    task = BoxReorientationTask(load_config(["task=BoxReorientation"])["task"])
    gen = torch.Generator().manual_seed(0)
    n = 20000
    r = task.reset_task(gen, n, torch.zeros(26))
    assert bool((r.box_pos[:, :2].abs() <= task.box_xy_range).all())
    assert bool((r.box_pos[:, 2] == task.box_z).all())
    yaw = _box_yaw(r.box_quat)
    assert abs(float(yaw.mean())) < 0.05 and float(yaw.abs().max()) <= math.pi
    off = r.task_states["target_yaw"] - yaw
    half = task.period / 2
    assert float(off.abs().min()) >= task.min_initial_error - 1e-5
    assert float(off.abs().max()) <= half + 1e-5
    assert abs(float((off > 0).float().mean()) - 0.5) < 0.02
    torch.testing.assert_close(r.task_states["prev_yaw_error"],
                               symmetric_angle_error(yaw, r.task_states["target_yaw"],
                                                     task.period))
    assert torch.equal(r.task_states["initial_box_pos"], r.box_pos)
    assert bool((r.task_states["aligned_duration_steps"] == 0).all())
    assert bool((r.dof_pos[:, 0:3].abs() <= task.hand_translation_range).all())
    assert bool((r.dof_pos[:, 3:6].abs() <= task.hand_rotation_range).all())
    fingers = r.dof_pos[:, 6:]
    assert bool((fingers >= 0).all()) and bool((fingers <= task.finger_range).all())
    assert abs(float(fingers.mean()) - task.finger_range / 2) < 0.005

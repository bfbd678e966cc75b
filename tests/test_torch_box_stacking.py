"""The port's BoxStacking env step held against the JAX package (CPU).

BoxStacking is the one two-body task (the pick cube and the platform cube,
`SimParams.has_box2`). A light config (4 envs, 2 physics steps of 1 substep
per control step, episodeLength 3 so an auto-reset fires) runs `reset_fn`
and three `step_fn` steps in the JAX package; the port replays them from its
own reset and from the JAX state carried over by convert.py, with the JAX
step's reset samples, at the tolerances of tests/test_golden_trajectory.py:
done exact, obs atol 2e-4, reward and each component atol 1e-3. Also: the
fused layout against the JAX package's, the plain fused step against the
unfused step bit for bit (with its `success_strict`/`done_strict` extras),
and the distribution of the port's own `reset_task` sampler (ranges, the
difficulty band and its at-top share, the reverse spawn).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.envs.fused_step import FusedLayout as JaxLayout
from dexrobot_isaac_tpu.factory import make_env as jax_make_env
from dexrobot_isaac_tpu.utils.config import load_config as jax_load_config
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.envs.tasks.box_stacking import BoxStackingTask
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils.config import load_config

T = torch.as_tensor
CONFIG = ["task=BoxStacking", "numEnvs=4", "env.episodeLength=3", "sim.substeps=1",
          "sim.physics_steps_per_control=2"]
SEED, STEPS = 5, 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX env's reset and 3 steps, with each step's reset sample (drawn
    as step_fn draws it) and the pre-step states."""
    env = jax_make_env(jax_load_config(CONFIG), seed=SEED)
    n, task = env.num_envs, env.comps.task
    actions = np.random.default_rng(SEED).uniform(-1, 1, (STEPS, n, env.num_actions)).astype(
        np.float32)
    key = jax.random.key(SEED)
    _, task_key, _ = jax.random.split(key, 3)
    sample = lambda k, d: jax.device_get(task.reset_task(k, n, env._default_dof, difficulty=d))
    state, obs = env._reset_jit(key)
    run = {"reset_sample": sample(task_key, jnp.asarray(env.comps.initial_difficulty, jnp.float32)),
           "reset_obs": np.asarray(obs), "states": [], "samples": [], "obs": [], "rew": [],
           "done": [], "comps": [], "strict": []}
    step = jax.jit(env.step_fn)
    for t in range(STEPS):
        _, reset_key, _ = jax.random.split(state.rng, 3)
        run["states"].append(jax.device_get(state))
        run["samples"].append(sample(reset_key, state.difficulty))
        state, obs, rew, done, ex = step(state, jnp.asarray(actions[t]))
        run["obs"].append(np.asarray(obs))
        run["rew"].append(np.asarray(rew))
        run["done"].append(np.asarray(done))
        run["comps"].append(jax.device_get(ex["reward_components"]))
        run["strict"].append({k: np.asarray(ex[k]) for k in ("success_strict", "done_strict")})
    run["actions"] = actions
    run["layout"] = JaxLayout(run["states"][0])
    assert np.any(run["done"]), "the scenario must exercise an auto-reset"
    return run


@pytest.fixture(scope="module")
def port_env():
    return make_env(load_config(CONFIG), seed=SEED, device="cpu")


def _roll(env, state, run):
    out = []
    for t in range(STEPS):
        state, obs, rew, done, ex = env.step_fn(
            state, T(run["actions"][t]), samples=(convert.task_reset(run["samples"][t], "cpu"),
                                                  None))
        out.append((obs.numpy(), rew.numpy(), done.numpy(), ex))
    return out


@pytest.fixture(scope="module")
def port_runs(port_env, jax_run):
    state, obs = port_env.reset_fn(
        samples=(convert.task_reset(jax_run["reset_sample"], "cpu"), None))
    return {"reset_obs": obs.numpy(), "own": _roll(port_env, state, jax_run),
            "carried": _roll(port_env, convert.env_state(jax_run["states"][0], "cpu"), jax_run)}


def test_scene_has_two_boxes(port_env):
    p = port_env.comps.engine.params
    assert p.has_box and p.has_box2 and p.box2_size == 0.08 and p.box2_friction == 1.2
    state, _ = port_env.reset_fn()
    assert state.physics.box2_pos.shape == (4, 3)
    assert torch.allclose(state.physics.box2_pos[:, 2], torch.full((4,), 0.04))


def test_reset_obs_matches_jax(port_runs, jax_run):
    np.testing.assert_allclose(port_runs["reset_obs"], jax_run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_matches_jax(port_runs, jax_run, start, t):
    obs, rew, done, ex = port_runs[start][t]
    np.testing.assert_array_equal(done, jax_run["done"][t])
    np.testing.assert_allclose(obs, jax_run["obs"][t], rtol=0, atol=2e-4)
    np.testing.assert_allclose(rew, jax_run["rew"][t], rtol=0, atol=1e-3)
    comps = ex["reward_components"]
    assert sorted(comps) == sorted(jax_run["comps"][t])
    for k, v in comps.items():
        np.testing.assert_allclose(v.numpy(), jax_run["comps"][t][k], rtol=0, atol=1e-3,
                                   err_msg=k)
    for k, v in jax_run["strict"][t].items():
        np.testing.assert_array_equal(ex[k].numpy(), v, err_msg=k)


def test_fused_layout_matches_jax(port_env, jax_run):
    jl = jax_run["layout"]
    fused = port_env.make_fused()
    tl = fused.layout
    assert tl.has_box2 and "box2_angvel" in tl.offs_f
    assert (tl.rows_f, tl.rows_i, tl.rows_c) == (jl.rows_f, jl.rows_i, jl.rows_c)
    assert (tl.offs_f, tl.offs_i, tl.offs_c) == (jl.offs_f, jl.offs_i, jl.offs_c)
    assert fused.rst_rows == 26 + 7 + 7 + 5 and fused.build == "fused_step_stacking"
    js = jax_run["states"][1]
    want = convert.fused_state(jax.device_get(jl.pack(js)), "cpu")
    got = fused.pack(convert.env_state(js, "cpu"))
    for k in ("rows_f", "rows_i", "rows_c"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    back = fused.unpack(got)
    assert torch.equal(back.physics.box2_pos, convert.tensor(js.physics.box2_pos, "cpu"))


def test_plain_fused_step_equals_unfused_step(port_env, jax_run):
    """Bit for bit, with the second box's reset rows and the strict
    extras (read from the pre-step spawn difficulty)."""
    fused = port_env.make_fused()
    state = convert.env_state(jax_run["states"][1], "cpu")
    sample = convert.task_reset(jax_run["samples"][1], "cpu")
    act = T(jax_run["actions"][1])
    new, obs, rew, done, ex = port_env.step_fn(state, act, samples=(sample, None))
    assert bool(done.any())
    rst, drn = fused.operand_rows(sample, state.dr, 4, "cpu")
    assert torch.equal(rst[33:40].t(), torch.cat([sample.box2_pos, sample.box2_quat], 1))
    fs, fobs, frew, fdone, fex = fused.step_fn(fused.pack(state), act, operands=(rst, drn))
    assert torch.equal(fobs, obs) and torch.equal(frew, rew) and torch.equal(fdone, done)
    packed = fused.pack(new)
    assert torch.equal(fs.rows_f, packed.rows_f) and torch.equal(fs.rows_i, packed.rows_i)
    comps = torch.stack([ex["reward_components"][k] for k in fused.comp_names], 1)
    assert torch.equal(fex["reward_components_packed"], comps)
    for k in ("success_strict", "done_strict"):
        assert torch.equal(fex[k], ex[k]), k


# ---------------------------------------------------------------- the sampler
def _task(**cur):
    cfg = load_config(["task=BoxStacking"])["task"]
    cfg["curriculum"] = {**cfg["curriculum"], **cur}
    return BoxStackingTask(cfg)


def _draw(task, difficulty, n=20000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return task.reset_task(gen, n, torch.zeros(26), difficulty=torch.tensor(difficulty),
                           project=False)


@pytest.mark.parametrize("difficulty", [0.0, 0.5, 1.0])
def test_reset_sampler_ranges(difficulty):
    t = _task()
    r = _draw(t, difficulty)
    sd = r.task_states["spawn_difficulty"]
    scale = t.curriculum_min_fraction + (1 - t.curriculum_min_fraction) * sd
    assert bool((r.box_pos[:, :2].abs() <= t.box_xy_range).all())
    assert bool((r.box_pos[:, 2] == t.box_z).all())
    yaw = 2 * torch.atan2(r.box_quat[:, 2], r.box_quat[:, 3])
    assert bool((yaw.abs() <= math.pi * scale + 1e-5).all())
    dist = torch.linalg.vector_norm(r.box2_pos[:, :2], dim=-1)
    assert bool((dist >= t.plat_dist_min - 1e-6).all())
    assert bool((dist <= t.plat_dist_min + (t.plat_dist_max - t.plat_dist_min) * scale + 1e-6).all())
    assert torch.allclose(r.box2_pos[:, :2], r.task_states["platform_spawn_xy"])
    assert bool((r.box2_pos[:, 2] == t.plat_size / 2).all())
    assert bool((r.dof_pos[:, 0:3].abs() <= t.hand_translation_range * scale[:, None] + 1e-6).all())
    assert bool((r.dof_pos[:, 6:] >= 0).all())
    assert bool((r.dof_pos[:, 6:] <= t.finger_range * scale[:, None] + 1e-6).all())
    stack = r.box2_pos + torch.tensor([0.0, 0.0, (t.plat_size + t.box_size) / 2])
    torch.testing.assert_close(r.task_states["prev_transport_dist"],
                               torch.linalg.vector_norm(stack - r.box_pos, dim=-1))
    assert bool((r.task_states["hold_duration_steps"] == 0).all())


def test_reset_sampler_difficulty_band():
    """U(d - band, d) per env, with band_top_fraction of the envs exactly at
    d; the band collapses at difficulty 1."""
    t = _task()
    sd = _draw(t, 0.5).task_states["spawn_difficulty"]
    at_top = sd == 0.5
    assert abs(float(at_top.float().mean()) - t.band_top_fraction) < 0.02
    banded = sd[~at_top]
    assert float(banded.min()) >= 0.5 - t.difficulty_band - 1e-6 and float(banded.max()) < 0.5
    assert abs(float(banded.mean()) - (0.5 - t.difficulty_band / 2)) < 0.01
    assert bool((_draw(t, 1.0).task_states["spawn_difficulty"] == 1.0).all())
    assert bool((_draw(_task(difficulty_band=0.0), 0.5).task_states["spawn_difficulty"]
                 == 0.5).all())


def test_reset_sampler_reverse_spawn():
    """reverse_spawn_fraction * (1 - d) of the resets start with the cube on
    the platform top."""
    t = _task(reverse_spawn_fraction=0.2, difficulty_band=0.0)
    r = _draw(t, 0.5)
    on_top = r.box_pos[:, 2] > t.plat_size
    assert abs(float(on_top.float().mean()) - 0.2 * 0.5) < 0.01
    xy_off = (r.box_pos[on_top, :2] - r.box2_pos[on_top, :2]).abs()
    assert float(xy_off.max()) <= 0.005 + 1e-6

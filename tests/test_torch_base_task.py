"""BaseTask on the port's fused step held against the JAX package (CPU).

BaseTask has no task step: K1's BaseTask build (`fused_step_base`) runs the
position_delta action pipeline, the physics without a box, the default
observations, the builtin hitting-ground criterion and the common rewards.
Its plain version (unpack -> the port's plain step -> pack) replays three
JAX `env.step_fn` steps of a light config (4 envs, 2 physics steps of 1
substep, episodeLength 3 so an auto-reset fires) from the port's own fused
reset and from the JAX state packed, with the JAX step's reset samples as
the kernel's operand rows: done exact, obs atol 2e-4, reward and each
component atol 1e-3 (tests/test_golden_trajectory.py:59-64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.envs.fused_step import FusedLayout as JaxLayout
from dexrobot_isaac_tpu.factory import make_env as jax_make_env
from dexrobot_isaac_tpu.utils.config import load_config as jax_load_config
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils.config import load_config

T = torch.as_tensor
CONFIG = ["task=BaseTask", "numEnvs=4", "env.episodeLength=3", "sim.substeps=1",
          "sim.physics_steps_per_control=2"]
SEED, STEPS = 11, 3


@pytest.fixture(scope="module")
def jax_run():
    env = jax_make_env(jax_load_config(CONFIG), seed=SEED)
    n, task = env.num_envs, env.comps.task
    actions = np.random.default_rng(SEED).uniform(-1, 1, (STEPS, n, env.num_actions)).astype(
        np.float32)
    key = jax.random.key(SEED)
    _, task_key, _ = jax.random.split(key, 3)
    sample = lambda k, d: jax.device_get(task.reset_task(k, n, env._default_dof, difficulty=d))
    state, obs = env._reset_jit(key)
    run = {"reset_sample": sample(task_key, jnp.asarray(1.0, jnp.float32)),
           "reset_obs": np.asarray(obs), "states": [], "samples": [], "obs": [], "rew": [],
           "done": [], "comps": []}
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
    run["actions"] = actions
    run["layout"] = JaxLayout(run["states"][0])
    assert np.any(run["done"]), "the scenario must exercise an auto-reset"
    return run


@pytest.fixture(scope="module")
def fused_runs(jax_run):
    env = make_env(load_config(CONFIG), seed=SEED, device="cpu")
    fused = env.make_fused()
    assert fused.build == "fused_step_base" and env.comps.pipeline.control_mode == "position_delta"
    fs0, obs0 = fused.reset(samples=(convert.task_reset(jax_run["reset_sample"], "cpu"), None))

    def roll(fs):
        out = []
        for t in range(STEPS):
            rst, drn = fused.operand_rows(convert.task_reset(jax_run["samples"][t], "cpu"), None,
                                          4, "cpu")
            fs, obs, rew, done, ex = fused.step_fn(fs, T(jax_run["actions"][t]),
                                                   operands=(rst, drn))
            comps = dict(zip(fused.comp_names, ex["reward_components_packed"].t()))
            out.append((obs.numpy(), rew.numpy(), done.numpy(), comps))
        return out

    carried = fused.pack(convert.env_state(jax_run["states"][0], "cpu"))
    return {"reset_obs": obs0.numpy(), "own": roll(fs0), "carried": roll(carried),
            "layout": fused.layout}


def test_fused_layout_matches_jax(fused_runs, jax_run):
    tl, jl = fused_runs["layout"], jax_run["layout"]
    assert (tl.rows_f, tl.rows_i, tl.rows_c) == (jl.rows_f, jl.rows_i, jl.rows_c)
    assert (tl.offs_f, tl.offs_i, tl.offs_c) == (jl.offs_f, jl.offs_i, jl.offs_c)


def test_reset_obs_matches_jax(fused_runs, jax_run):
    np.testing.assert_allclose(fused_runs["reset_obs"], jax_run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_plain_fused_step_matches_jax(fused_runs, jax_run, start, t):
    obs, rew, done, comps = fused_runs[start][t]
    np.testing.assert_array_equal(done, jax_run["done"][t])
    np.testing.assert_allclose(obs, jax_run["obs"][t], rtol=0, atol=2e-4)
    np.testing.assert_allclose(rew, jax_run["rew"][t], rtol=0, atol=1e-3)
    assert sorted(comps) == sorted(jax_run["comps"][t])
    for k, v in comps.items():
        np.testing.assert_allclose(v.numpy(), jax_run["comps"][t][k], rtol=0, atol=1e-3,
                                   err_msg=k)

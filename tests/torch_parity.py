"""Helpers of the port's parity tests: a JAX env's reset and steps with the
random draws of each step, and the port's replay of them (CPU).

The JAX step samples its resets and DR scales with `jax.random`, which torch
cannot reproduce, so the port takes them as operands (ROADMAP rule "Random
draws"): `jax_rollout` records, before each JAX step, the reset sample and
the DR sample that step draws (from the same keys), and `port_roll` hands
them to the port's `step_fn`.
"""

import inspect

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.envs.fused_step import FusedLayout as JaxLayout
from dexrobot_isaac_tpu.factory import make_env as jax_make_env
from dexrobot_isaac_tpu.physics.types import DRSample as JaxDRSample
from dexrobot_isaac_tpu.utils.config import load_config as jax_load_config
from dexrobot_isaac_tpu_torch import convert

T = torch.as_tensor


def jax_rollout(config, seed, steps, extras=(), task=None):
    """The JAX env's reset and `steps` steps of uniform random actions, with
    each step's reset sample (unprojected, drawn as step_fn draws it), its
    DR sample (None without DR), the pre-step states, and the `extras` keys
    of each step's extras. `task` names a registered task in place of the
    config's (a subclass with action hooks)."""
    cfg = jax_load_config(config)
    if task is not None:
        cfg["task"]["name"] = task
    env = jax_make_env(cfg, seed=seed)
    n, task, c = env.num_envs, env.comps.task, env.comps
    actions = np.random.default_rng(seed).uniform(-1, 1, (steps, n, env.num_actions)).astype(
        np.float32)
    kw = {"project": False} if "project" in inspect.signature(task.reset_task).parameters else {}
    sample = lambda k, d: jax.device_get(
        task.reset_task(k, n, env._default_dof, difficulty=d, **kw))
    dr = lambda k: jax.device_get(JaxDRSample.sample(k, n, c.dr_ranges)) if c.dr_ranges else None
    key = jax.random.key(seed)
    _, task_key, dr_key = jax.random.split(key, 3)
    state, obs = env._reset_jit(key)
    run = {"reset_sample": sample(task_key, jnp.asarray(c.initial_difficulty, jnp.float32)),
           "reset_dr": dr(dr_key), "reset_obs": np.asarray(obs), "states": [], "samples": [],
           "drs": [], "obs": [], "rew": [], "done": [], "comps": [], "extras": []}
    step = jax.jit(env.step_fn)
    for t in range(steps):
        _, reset_key, dr_key = jax.random.split(state.rng, 3)
        run["states"].append(jax.device_get(state))
        run["samples"].append(sample(reset_key, state.difficulty))
        run["drs"].append(dr(dr_key))
        state, obs, rew, done, ex = step(state, jnp.asarray(actions[t]))
        run["obs"].append(np.asarray(obs))
        run["rew"].append(np.asarray(rew))
        run["done"].append(np.asarray(done))
        run["comps"].append(jax.device_get(ex["reward_components"]))
        run["extras"].append({k: np.asarray(ex[k]) for k in extras})
    run["actions"] = actions
    run["layout"] = JaxLayout(run["states"][0])
    assert np.any(run["done"]), "the scenario must exercise an auto-reset"
    return run


def samples_at(run, t):
    """The port's `samples` operand of JAX step t."""
    dr = run["drs"][t]
    return (convert.task_reset(run["samples"][t], "cpu"),
            None if dr is None else convert.dr_sample(dr, "cpu"))


def port_roll(env, state, run):
    """The port's `step_fn` through the JAX run's actions and samples from
    `state`: [(obs, rew, done, extras)] per step."""
    out = []
    for t in range(len(run["actions"])):
        state, obs, rew, done, ex = env.step_fn(state, T(run["actions"][t]),
                                                samples=samples_at(run, t))
        out.append((obs.numpy(), rew.numpy(), done.numpy(), ex))
    return out


def port_runs(env, run):
    """The port's reset (from the JAX reset's samples) and its replay of the
    JAX steps, from its own reset ("own") and from the JAX state carried over
    by convert.py ("carried")."""
    dr = run["reset_dr"]
    state, obs = env.reset_fn(samples=(convert.task_reset(run["reset_sample"], "cpu"),
                                       None if dr is None else convert.dr_sample(dr, "cpu")))
    return {"reset_obs": obs.numpy(), "own": port_roll(env, state, run),
            "carried": port_roll(env, convert.env_state(run["states"][0], "cpu"), run)}


def assert_step_matches(port, run, t):
    """Step t of the port against JAX: done exact, obs atol 2e-4, reward and
    each component atol 1e-3 (tests/test_golden_trajectory.py)."""
    obs, rew, done, ex = port[t]
    np.testing.assert_array_equal(done, run["done"][t])
    np.testing.assert_allclose(obs, run["obs"][t], rtol=0, atol=2e-4)
    np.testing.assert_allclose(rew, run["rew"][t], rtol=0, atol=1e-3)
    comps = ex["reward_components"]
    assert sorted(comps) == sorted(run["comps"][t])
    for k, v in comps.items():
        np.testing.assert_allclose(v.numpy(), run["comps"][t][k], rtol=0, atol=1e-3, err_msg=k)
    for k, v in run["extras"][t].items():
        np.testing.assert_array_equal(ex[k].numpy(), v, err_msg=k)


def assert_layout_matches(fused, run):
    """The port's packed fused layout against the JAX package's, and a JAX
    state packed both ways."""
    jl, tl = run["layout"], fused.layout
    assert (tl.rows_f, tl.rows_i, tl.rows_c) == (jl.rows_f, jl.rows_i, jl.rows_c)
    assert (tl.offs_f, tl.offs_i, tl.offs_c) == (jl.offs_f, jl.offs_i, jl.offs_c)
    js = run["states"][1]
    want = convert.fused_state(jax.device_get(jl.pack(js)), "cpu")
    got = fused.pack(convert.env_state(js, "cpu"))
    for k in ("rows_f", "rows_i", "rows_c"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def assert_fused_equals_unfused(env, run, t=1):
    """The plain fused step equals the unfused step bit for bit, on the JAX
    state before step t with that step's samples."""
    fused = env.make_fused()
    state = convert.env_state(run["states"][t], "cpu")
    sample, dr = samples_at(run, t)
    act = T(run["actions"][t])
    new, obs, rew, done, ex = env.step_fn(state, act, samples=(sample, dr))
    n = act.shape[0]
    rst, drn = fused.operand_rows(sample, dr, n, "cpu")
    fs, fobs, frew, fdone, fex = fused.step_fn(fused.pack(state), act, operands=(rst, drn))
    assert torch.equal(fobs, obs) and torch.equal(frew, rew) and torch.equal(fdone, done)
    packed = fused.pack(new)
    assert torch.equal(fs.rows_f, packed.rows_f) and torch.equal(fs.rows_i, packed.rows_i)
    comps = torch.stack([ex["reward_components"][k] for k in fused.comp_names], 1)
    assert torch.equal(fex["reward_components_packed"], comps)
    return done


def assert_visual_geoms_equal(got, want):
    """Two `HandModel.visual_geoms` lists: the same kinds and bodies, and
    their arrays and radii equal (atol 0)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], int(g[1]), len(g)) == (w[0], int(w[1]), len(w)), (g, w)
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=g[0])

"""The port's BlindGrasping env step held against the JAX package (CPU).

(a) The golden scenario (tests/golden_scenario.py: 8 envs, sim.substeps=2,
    episodeLength=6, seed 123, 12 steps) replayed through the port's plain
    fused path with the JAX-sampled reset/DR operands of
    dexrobot_isaac_tpu_torch/data/golden_operands.npz, held to the TPU-recorded
    tests/golden/fused_blind_grasping.npz at the tolerances of
    tests/test_golden_trajectory.py: obs atol 2e-4, reward and components
    atol 1e-3, done exact.
(b) `reset_fn` and three `step_fn` steps against the JAX `env.step_fn`, both
    from the port's own reset and from the JAX state carried over by
    convert.py, with the JAX step's reset samples (a light config: 2
    substeps per step, episodeLength 3 so an auto-reset fires); every
    extra too: the termination rates and criterion means within 1e-6,
    the masks and the reason flags exactly.
(c) The packed fused layout against the JAX package's.
(d) The unfused step with `sim.coriolis=true` (the port's Coriolis control
    step, the SPD solve K3's path) against the JAX `env.step_fn`, with the
    JAX step's reset samples, at the tolerances of (b). The JAX factory does
    not read `sim.coriolis` (its `build_sim_params` drops the key), so the
    test hands the JAX env `SimParams(coriolis=True)` itself.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu import factory as jax_factory
from dexrobot_isaac_tpu.envs.fused_step import FusedLayout as JaxLayout
from dexrobot_isaac_tpu.factory import make_env as jax_make_env
from dexrobot_isaac_tpu.utils.config import load_config as jax_load_config
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
from dexrobot_isaac_tpu_torch.envs.tasks.api import TaskStep
from dexrobot_isaac_tpu_torch.envs.tasks.base_task import BaseTask
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import golden_scenario as gs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "dexrobot_isaac_tpu_torch", "data", "golden_operands.npz")
GOLDEN_PATH = os.path.join(REPO, "tests", gs.GOLDEN)
T = torch.as_tensor
STEP_CONFIG = ["task=BlindGrasping", "numEnvs=8", "env.episodeLength=3", "sim.substeps=1",
               "sim.physics_steps_per_control=2"]
CORIOLIS_CONFIG = STEP_CONFIG + ["sim.coriolis=true"]
SEED, STEPS = 5, 3


# ---------------------------------------------------------------- (a) golden
@pytest.fixture(scope="module")
def golden_replay():
    ops = {k: T(v) for k, v in np.load(FIXTURE).items()}
    env = make_env(load_config(list(gs.CONFIG)), seed=gs.SEED, device="cpu")
    fused = env.make_fused()
    fs, _ = fused.reset(samples=(fused.reset_from_rows(ops["init_rst"]), None))
    out = {k: [] for k in ("obs", "rew", "done", "comp")}
    for t in range(gs.STEPS):
        fs, obs, rew, done, ex = fused.step_fn(fs, ops["actions"][t],
                                              operands=(ops["rst"][t], ops["drn"][t]))
        for k, v in (("obs", obs), ("rew", rew), ("done", done),
                     ("comp", ex["reward_components_packed"])):
            out[k].append(v.numpy())
    return {k: np.stack(v) for k, v in out.items()}, dict(np.load(GOLDEN_PATH))


def test_golden_done_masks_exact(golden_replay):
    got, want = golden_replay
    np.testing.assert_array_equal(got["done"], want["done"])
    assert want["done"].any()


@pytest.mark.parametrize("key,atol", [("obs", 2e-4), ("rew", 1e-3), ("comp", 1e-3)])
def test_golden_replay_within_budget(golden_replay, key, atol):
    got, want = golden_replay
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)


# ---------------------------------------------------------------- (b) step_fn
@pytest.fixture(scope="module")
def jax_run():
    return _jax_rollout(STEP_CONFIG)


def _jax_rollout(config, coriolis=False):
    """The JAX env's reset and 3 steps, with each step's reset sample (drawn
    as step_fn draws it, unprojected) and the pre-step states."""
    with pytest.MonkeyPatch.context() as mp:
        build = jax_factory.build_sim_params
        mp.setattr(jax_factory, "build_sim_params",
                   lambda cfg: dataclasses.replace(build(cfg), coriolis=coriolis))
        env = jax_make_env(jax_load_config(config), seed=SEED)
    assert env.comps.engine.params.coriolis == coriolis
    n, task = env.num_envs, env.comps.task
    actions = np.random.default_rng(SEED).uniform(-1, 1, (STEPS, n, env.num_actions)).astype(
        np.float32)
    key = jax.random.key(SEED)
    _, task_key, _ = jax.random.split(key, 3)
    diff = jnp.asarray(env.comps.initial_difficulty, jnp.float32)
    sample = lambda k, d: jax.device_get(
        task.reset_task(k, n, env._default_dof, difficulty=d, project=False))
    state, obs = env._reset_jit(key)
    run = {"reset_sample": sample(task_key, diff), "reset_obs": np.asarray(obs),
           "states": [], "samples": [], "obs": [], "rew": [], "done": [], "comps": [],
           "term": []}
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
        run["term"].append({k: np.asarray(v) for k, v in ex.items()
                            if k != "reward_components"})
    run["actions"] = actions
    run["layout"] = JaxLayout(run["states"][0])
    assert np.any(run["done"]), "the scenario must exercise an auto-reset"
    return run


@pytest.fixture(scope="module")
def port_env():
    return make_env(load_config(STEP_CONFIG), seed=SEED, device="cpu")


def _roll(env, state, run):
    out = []
    for t in range(STEPS):
        state, obs, rew, done, ex = env.step_fn(
            state, T(run["actions"][t]), samples=(convert.task_reset(run["samples"][t], "cpu"), None))
        out.append((obs.numpy(), rew.numpy(), done.numpy(), ex["reward_components"],
                    {k: v.numpy() for k, v in ex.items() if k != "reward_components"}))
    return out


@pytest.fixture(scope="module")
def port_runs(port_env, jax_run):
    state, obs = port_env.reset_fn(samples=(convert.task_reset(jax_run["reset_sample"], "cpu"), None))
    return {"reset_obs": obs.numpy(), "own": _roll(port_env, state, jax_run),
            "carried": _roll(port_env, convert.env_state(jax_run["states"][0], "cpu"), jax_run)}


def test_reset_obs_matches_jax(port_runs, jax_run):
    np.testing.assert_allclose(port_runs["reset_obs"], jax_run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_matches_jax(port_runs, jax_run, start, t):
    obs, rew, done, comps, _ = port_runs[start][t]
    np.testing.assert_array_equal(done, jax_run["done"][t])
    np.testing.assert_allclose(obs, jax_run["obs"][t], rtol=0, atol=2e-4)
    np.testing.assert_allclose(rew, jax_run["rew"][t], rtol=0, atol=1e-3)
    assert sorted(comps) == sorted(jax_run["comps"][t])
    for k, v in comps.items():
        np.testing.assert_allclose(v.numpy(), jax_run["comps"][t][k], rtol=0, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_extras_match_jax(port_runs, jax_run, start, t):
    """Every other extra of the step: the termination rates and criterion
    means (atol 1e-6) and the masks, reason flags, counters (exact)."""
    got, want = port_runs[start][t][4], jax_run["term"][t]
    assert sorted(got) == sorted(want)
    assert {"success_rate", "failure_rate", "timeout_rate", "success_grasp_lift_success",
            "failure_reason_hitting_ground"} <= set(got)
    for k, v in got.items():
        if v.dtype.kind == "f":
            assert v.shape == want[k].shape == (), k
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------- (c) layout
def test_fused_layout_matches_jax(port_env, jax_run):
    jl = jax_run["layout"]
    fused = port_env.make_fused()
    tl = fused.layout
    assert (tl.rows_f, tl.rows_i, tl.rows_c) == (jl.rows_f, jl.rows_i, jl.rows_c)
    assert (tl.offs_f, tl.offs_i, tl.offs_c) == (jl.offs_f, jl.offs_i, jl.offs_c)
    js = jax_run["states"][1]
    want = convert.fused_state(jax.device_get(jl.pack(js)), "cpu")
    got = fused.pack(convert.env_state(js, "cpu"))
    for k in ("rows_f", "rows_i", "rows_c"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    back = fused.unpack(got)
    assert torch.equal(back.physics.q, got.rows_f[:26].t())
    assert torch.equal(back.task_states["current_stage"],
                       convert.tensor(js.task_states["current_stage"], "cpu"))


def test_plain_fused_step_equals_unfused_step(port_env, jax_run):
    fused = port_env.make_fused()
    state = convert.env_state(jax_run["states"][1], "cpu")
    sample = convert.task_reset(jax_run["samples"][1], "cpu")
    act = T(jax_run["actions"][1])
    new, obs, rew, done, ex = port_env.step_fn(state, act, samples=(sample, None))
    rst, drn = fused.operand_rows(sample, state.dr, 8, "cpu")
    fs, fobs, frew, fdone, fex = fused.step_fn(fused.pack(state), act, operands=(rst, drn))
    assert torch.equal(fobs, obs) and torch.equal(frew, rew) and torch.equal(fdone, done)
    packed = fused.pack(new)
    assert torch.equal(fs.rows_f, packed.rows_f) and torch.equal(fs.rows_i, packed.rows_i)
    comps = torch.stack([ex["reward_components"][k] for k in fused.comp_names], 1)
    assert torch.equal(fex["reward_components_packed"], comps)


# ---------------------------------------------------------------- (d) Coriolis
@pytest.fixture(scope="module")
def coriolis_runs():
    run = _jax_rollout(CORIOLIS_CONFIG, coriolis=True)
    env = make_env(load_config(CORIOLIS_CONFIG), seed=SEED, device="cpu")
    assert env.comps.engine.params.coriolis
    return run, _roll(env, convert.env_state(run["states"][0], "cpu"), run)


@pytest.mark.parametrize("t", range(STEPS))
def test_coriolis_step_fn_matches_jax(coriolis_runs, t):
    run, port = coriolis_runs
    obs, rew, done, _, _ = port[t]
    np.testing.assert_array_equal(done, run["done"][t])
    np.testing.assert_allclose(obs, run["obs"][t], rtol=0, atol=2e-4)
    np.testing.assert_allclose(rew, run["rew"][t], rtol=0, atol=1e-3)


def test_fused_step_refuses_unported_task():
    """What K1 still refuses: a task with a custom pre-action rule (the port
    runs the default rule only) makes `make_fused` raise FusedUnsupported,
    and so does a task without a K1 build of its own (a subclass of a
    ported task that overrides its step)."""
    env = make_env(load_config(["task=BoxPushing", "numEnvs=2"]), device="cpu")
    assert env.make_fused().build == "fused_step_pushing"
    env.comps.task.pre_action_rule = lambda *args: None
    with pytest.raises(FusedUnsupported, match="pre-action rule"):
        env.make_fused()

    class OwnStep(BaseTask):
        name = "OwnStep"

        def compute_step(self, obs_dict, task_states, *args, **kwargs):
            return TaskStep({}, task_states, {}, {}, {})

    env = make_env(load_config(["task=BaseTask", "numEnvs=2"]), device="cpu")
    env.comps.task = OwnStep(env.comps.task.cfg)
    with pytest.raises(FusedUnsupported, match="OwnStep"):
        env.make_fused()

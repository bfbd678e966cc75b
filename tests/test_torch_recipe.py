"""The README recipe and the shipped experiments, held against the JAX package
(CPU).

`experiments=BlindGraspingCurriculum` is the recipe the README trains
(40 observation keys: 158 policy and 135 critic dims through an asymmetric
critic); `BlindGraspingClearance` adds the under-box penalty (two more reward
components, 443 of K1's output words per env); `BlindGraspingDR` and
`BoxStackingDR` turn domain randomization on, so the done-masked DR merge
and the fused step's DR rows hold values other than ones. Each runs at a
light size (8 envs, 2 physics steps of 1 substep per control step,
episodeLength 3 so an auto-reset fires): `reset_fn` and three `step_fn`
steps of the JAX package, replayed by the port from its own reset and from
the JAX state, with the JAX step's reset and DR draws as operands: done
exact, obs atol 2e-4, reward and each component atol 1e-3. Also the fused
layout, and the plain fused step against the unfused step bit for bit.
"""

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.physics.types import DR_FIELDS
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_parity as tp

LIGHT = ["numEnvs=8", "env.episodeLength=3", "sim.substeps=1", "sim.physics_steps_per_control=2"]
# the DR pair runs in tests/test_torch_recipe_dr.py: each experiment's JAX
# rollout takes 128-152 s under the tier-1 command's six workers, and the four
# in one file took 567 s there
EXPERIMENTS = ("BlindGraspingCurriculum", "BlindGraspingClearance")
SEED, STEPS = 5, 3


def build_case(name):
    config = [f"experiments={name}"] + LIGHT
    extras = ("success_strict", "done_strict") if name == "BoxStackingDR" else ()
    run = tp.jax_rollout(config, SEED, STEPS, extras)
    env = make_env(load_config(config), seed=SEED, device="cpu")
    return name, env, run, tp.port_runs(env, run)


@pytest.fixture(scope="module", params=EXPERIMENTS)
def case(request):
    return build_case(request.param)


def test_experiment_shape(case):
    name, env, run, _ = case
    keys = env.comps.obs_cfg
    if name.startswith("BlindGrasping"):
        assert len(keys.policy_observation_keys) + len(keys.critic_observation_keys) == 40
        assert (env.num_obs, env.num_states) == (158, 135)
    assert (env.comps.dr_ranges is not None) == name.endswith("DR")
    assert run["obs"][0].shape == (8, env.num_obs + env.num_states)


def test_reset_obs_matches_jax(case):
    _, _, run, port = case
    np.testing.assert_allclose(port["reset_obs"], run["reset_obs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_step_fn_matches_jax(case, start, t):
    _, _, run, port = case
    tp.assert_step_matches(port[start], run, t)


def test_dr_merge_matches_jax(case):
    """The DR scales after each step: the done envs take the step's draw,
    the others keep theirs, as in the JAX state (equal bits); with DR on
    they are not all ones."""
    name, env, run, _ = case
    state = tp.convert.env_state(run["states"][0], "cpu")
    for t in range(STEPS):
        state, *_ = env.step_fn(state, tp.T(run["actions"][t]), samples=tp.samples_at(run, t))
        want = run["states"][t + 1].dr if t + 1 < STEPS else None
        if want is not None:
            for k in DR_FIELDS:
                np.testing.assert_array_equal(getattr(state.dr, k).numpy(),
                                              np.asarray(getattr(want, k)), err_msg=k)
    rows = state.dr.rows()
    assert bool((rows != 1).any()) == name.endswith("DR")


def test_fused_layout_matches_jax(case):
    _, env, run, _ = case
    tp.assert_layout_matches(env.make_fused(), run)


def test_plain_fused_step_equals_unfused_step(case):
    _, env, run, _ = case
    t = int(np.argmax([d.any() for d in run["done"]]))  # a step with a reset
    done = tp.assert_fused_equals_unfused(env, run, t)
    assert bool(done.any())
    fused = env.make_fused()
    sample, dr = tp.samples_at(run, t)
    _, drn = fused.operand_rows(sample, dr, 8, "cpu")
    assert bool((drn != 1).any()) == (dr is not None)
    assert torch.equal(drn, torch.ones(4, 8)) == (dr is None)

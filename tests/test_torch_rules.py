"""The port's action hooks, rule-based controllers and env user API, held
against the JAX package (CPU).

(a) `envs/rule_based.py`: the cases of tests/test_rule_based.py on the
    port's controllers, and the port's and the JAX controllers on the same
    random inputs (atol 1e-6).
(b) The hooks on the unfused step: BlindGrasping (8 envs, 2 substeps,
    episodeLength 6) with a pre-action rule that moves the base on a circle
    (the policy controls the fingers only), a custom action rule that halves
    the actions and a custom filter that caps the finger targets, stepped
    12 times in the JAX env and in the port's: obs atol 2e-4, reward and
    components atol 1e-3, done exact, and after each step the rule targets
    and the base DOF targets atol 1e-5. The fused step declines the hooks,
    naming them.
(c) The env's user API (JAX dexhand.py:575-657): observation and action
    spaces, the critic slice, `set_difficulty`, every `get_obs_slice` and
    `get_obs_index_for_*` result against the JAX env's on BlindGrasping and
    on the recipe (with its critic keys), `toggle_random_actions`, `seed`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dexrobot_isaac_tpu import factory as jax_factory
from dexrobot_isaac_tpu.envs import action as jax_action
from dexrobot_isaac_tpu.envs import rule_based as jax_rb
from dexrobot_isaac_tpu.envs.tasks.blind_grasping import BlindGraspingTask as JaxBlindGrasping
from dexrobot_isaac_tpu.factory import make_env as jax_make_env
from dexrobot_isaac_tpu.utils.config import load_config as jax_load_config
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch import factory as port_factory
from dexrobot_isaac_tpu_torch.constants import BASE_JOINT_NAMES
from dexrobot_isaac_tpu_torch.envs import action as port_action
from dexrobot_isaac_tpu_torch.envs import rule_based as rb
from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
from dexrobot_isaac_tpu_torch.envs.tasks.blind_grasping import BlindGraspingTask
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_parity as tp

T = torch.as_tensor


# ---------------------------------------------------------------- (a) controllers
def _obs(t, contact=None):
    n = len(t)
    return {"episode_time": torch.tensor(t, dtype=torch.float32)[:, None],
            "contact_binary": torch.zeros(n, 5) if contact is None else T(contact).float()}


def test_circular_base_starts_at_origin_offset():
    rule = rb.make_pre_action_rule(base_controller=rb.circular_base_motion(0.1, 4.0))
    out = rule(torch.zeros(2, 18), _obs([0.0, 0.0]))
    torch.testing.assert_close(out[:, :2], torch.zeros(2, 2), rtol=0, atol=1e-6)


def test_circular_base_quarter_period():
    rule = rb.make_pre_action_rule(base_controller=rb.circular_base_motion(0.1, 4.0))
    out = rule(torch.zeros(1, 18), _obs([1.0]))
    assert abs(float(out[0, 0]) + 0.1) < 1e-6 and abs(float(out[0, 1]) - 0.1) < 1e-6


def test_circular_base_leaves_fingers():
    rule = rb.make_pre_action_rule(base_controller=rb.circular_base_motion())
    prev = torch.ones(1, 18) * 0.5
    out = rule(prev, _obs([2.0]))
    torch.testing.assert_close(out[0, 6:], prev[0, 6:], rtol=0, atol=1e-6)
    assert torch.equal(prev, torch.ones(1, 18) * 0.5)  # the input is not written


def test_adaptive_grasp_closes_without_contact():
    rule = rb.make_pre_action_rule(finger_controller=rb.adaptive_grasp())
    fingers = rule(torch.zeros(2, 18), _obs([0.0, 0.0]))[:, 6:]
    assert bool((fingers[:, [0, 1, 2]] > 0).all())
    assert bool((fingers[:, 3] == 0).all())  # the spread stays


def test_adaptive_grasp_holds_on_contact():
    rule = rb.make_pre_action_rule(finger_controller=rb.adaptive_grasp())
    contact = np.zeros((1, 5))
    contact[0, 0] = 1.0  # the thumb in contact
    fingers = rule(torch.zeros(1, 18), _obs([0.0], contact))[0, 6:]
    assert abs(float(fingers[0])) < 1e-7 and float(fingers[4]) > 0


@pytest.mark.parametrize("which", ["base", "fingers", "both"])
def test_controllers_match_jax(which):
    rng = np.random.default_rng(3)
    n = 64
    prev = rng.uniform(-1, 1, (n, 18)).astype(np.float32)
    t = rng.uniform(0, 10, n).astype(np.float32)
    contact = (rng.uniform(size=(n, 5)) > 0.5).astype(np.float32)
    kw = lambda m: {
        "base_controller": m.circular_base_motion(0.07, 3.0, z_amplitude=0.02)
        if which != "fingers" else None,
        "finger_controller": m.adaptive_grasp(0.7, control_dt=0.04) if which != "base" else None}
    want = jax_rb.make_pre_action_rule(**kw(jax_rb))(
        jnp.asarray(prev), {"episode_time": jnp.asarray(t)[:, None],
                            "contact_binary": jnp.asarray(contact)})
    got = rb.make_pre_action_rule(**kw(rb))(T(prev), {"episode_time": T(t)[:, None],
                                                      "contact_binary": T(contact)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- (b) the hooks
HOOKED = "BlindGraspingHooked"
HOOK_CONFIG = ["task=BlindGrasping", "numEnvs=8", "env.episodeLength=6", "sim.substeps=1",
               "sim.physics_steps_per_control=2", "task.policy_controls_hand_base=false"]
HOOK_STEPS = 12


def _hooked(base, m, action_mod, cap):
    """`base` with the three hooks, built from one package's modules."""
    return type(HOOKED, (base,), {
        "pre_action_rule": staticmethod(m.make_pre_action_rule(
            base_controller=m.circular_base_motion(radius=0.05, period=0.2))),
        "custom_action_rule": staticmethod(
            lambda pl, prev, rule, a: action_mod.position_action_rule(pl, prev, rule, a * 0.5)),
        "custom_post_filters": (cap,),
    })


def _cap_jax(pl, prev, rule, t):
    return t.at[:, 6:].set(jnp.minimum(t[:, 6:], 0.6))


def _cap_port(pl, prev, rule, t):
    return torch.cat([t[:, :6], t[:, 6:].clamp(max=0.6)], 1)


@pytest.fixture(scope="module")
def hooked_runs():
    """The JAX rollout and the port's replay of it (its own reset from the
    JAX reset sample), with the port's state after each step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_factory.TASK_REGISTRY, HOOKED,
                   _hooked(JaxBlindGrasping, jax_rb, jax_action, _cap_jax))
        mp.setitem(port_factory.TASK_REGISTRY, HOOKED,
                   _hooked(BlindGraspingTask, rb, port_action, _cap_port))
        run = tp.jax_rollout(HOOK_CONFIG, 7, HOOK_STEPS, task=HOOKED)
        cfg = load_config(HOOK_CONFIG)
        cfg["task"]["name"] = HOOKED
        env = make_env(cfg, seed=7, device="cpu")
        state, obs = env.reset_fn(samples=(convert.task_reset(run["reset_sample"], "cpu"), None))
        reset_rule = state.active_rule_targets
        out, states = [], []
        for t in range(HOOK_STEPS):
            state, obs, rew, done, ex = env.step_fn(state, T(run["actions"][t]),
                                                    samples=tp.samples_at(run, t))
            out.append((obs.numpy(), rew.numpy(), done.numpy(), ex))
            states.append(state)
        yield run, env, out, states, reset_rule


def test_hooked_env_has_policy_fingers_only(hooked_runs):
    run, env, _, _, _ = hooked_runs
    assert env.num_actions == 12 == run["actions"].shape[-1]
    assert env.comps.pipeline.custom_action_rule is not None
    assert len(env.comps.pipeline.custom_filters) == 1


@pytest.mark.parametrize("t", range(HOOK_STEPS))
def test_hooked_step_matches_jax(hooked_runs, t):
    run, _, out, _, _ = hooked_runs
    tp.assert_step_matches(out, run, t)


def test_hooked_reset_rule_matches_jax(hooked_runs):
    run, _, _, _, reset_rule = hooked_runs
    np.testing.assert_allclose(reset_rule.numpy(), run["states"][0].active_rule_targets,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", range(HOOK_STEPS - 1))
def test_hooked_targets_match_jax(hooked_runs, t):
    """After step t: the rule's targets and the base DOF targets (which
    only the rule moves) equal the JAX state's before step t + 1."""
    run, _, _, states, _ = hooked_runs
    want = run["states"][t + 1]
    got = states[t]
    np.testing.assert_allclose(got.active_rule_targets.numpy(), want.active_rule_targets,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.full_dof_targets[:, :6].numpy(),
                               np.asarray(want.full_dof_targets)[:, :6], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.active_prev_targets.numpy(), want.active_prev_targets,
                               rtol=0, atol=1e-5)


def test_hooks_move_the_base(hooked_runs):
    """The scenario exercises the rule: the base targets leave the reset's."""
    run, _, _, states, _ = hooked_runs
    assert float(np.abs(np.asarray(run["states"][3].full_dof_targets)[:, :2]).max()) > 1e-3
    assert float(states[2].full_dof_targets[:, :2].abs().max()) > 1e-3


def test_fused_step_declines_the_hooks(hooked_runs):
    _, env, _, _, _ = hooked_runs
    with pytest.raises(FusedUnsupported,
                       match="pre_action_rule, custom_action_rule, custom_post_filters"):
        env.make_fused()


# ---------------------------------------------------------------- (c) the user API
RECIPE = ["experiments=BlindGraspingCurriculum", "numEnvs=2"]


@pytest.fixture(scope="module", params=[["task=BlindGrasping", "numEnvs=2"], RECIPE],
                ids=["BlindGrasping", "recipe"])
def api_envs(request):
    return (make_env(load_config(request.param), device="cpu"),
            jax_make_env(jax_load_config(request.param)))


def test_obs_slices_match_jax(api_envs):
    env, jenv = api_envs
    assert env.obs_slices == jenv.obs_slices
    for key in jenv.obs_slices:
        assert env.get_obs_slice(key) == jenv.get_obs_slice(key)
    with pytest.raises(KeyError):
        env.get_obs_slice("no_such_key")
    assert (env.num_obs, env.num_states) == (jenv.num_obs, jenv.num_states)
    assert env.observation_space.shape == jenv.observation_space.shape == (env.num_obs,)
    assert env.action_space.shape == (env.num_actions,)
    assert (env.action_space.low, env.action_space.high) == (-1.0, 1.0)


@pytest.mark.parametrize("obs_type", ["pos", "vel", "target"])
def test_obs_indices_match_jax(api_envs, obs_type):
    env, jenv = api_envs
    for name in BASE_JOINT_NAMES:
        _same_or_both_raise(lambda e: e.get_obs_index_for_base_joint(name, obs_type), env, jenv)
    for k in range(12):
        _same_or_both_raise(lambda e: e.get_obs_index_for_finger_control(k, obs_type), env, jenv)


def _same_or_both_raise(fn, env, jenv):
    try:
        want = fn(jenv)
    except KeyError:
        with pytest.raises(KeyError):
            fn(env)
        return
    assert fn(env) == want


def test_critic_slice_appended():
    env = make_env(load_config(["task=BlindGrasping", "numEnvs=2",
                                "task.critic_observation_keys=[object_pos, object_vel, "
                                "grasp_state]"]), device="cpu")
    assert env.num_obs == 158 and env.num_states == 3 + 3 + 1
    assert env.observation_space.shape == (158,)
    _, obs = env.reset_fn()
    assert obs.shape == (2, 158 + 7)


def test_set_difficulty_threads_through_step():
    env = make_env(load_config(["task=BlindGrasping", "numEnvs=2", "sim.substeps=1",
                                "sim.physics_steps_per_control=1"]), device="cpu")
    env.set_difficulty(0.5)  # before a reset: nothing to set
    env.reset()
    assert float(env.state.difficulty) == pytest.approx(env.comps.initial_difficulty)
    env.step(torch.zeros(2, 18))
    env.set_difficulty(0.3)
    assert float(env.state.difficulty) == pytest.approx(0.3)
    env.step(torch.zeros(2, 18))
    assert float(env.state.difficulty) == pytest.approx(0.3)
    assert env.state.difficulty.dtype == torch.float32
    env.close()


def test_random_actions_and_seed():
    """The override draws uniform actions from the env's generator; `seed`
    makes a run repeat."""
    env = make_env(load_config(["task=BaseTask", "numEnvs=3", "sim.substeps=1",
                                "sim.physics_steps_per_control=1"]), device="cpu")

    def run():
        env.seed(11)
        env.reset()
        obs, *_ = env.step(torch.zeros(3, env.num_actions))
        return obs, env.state.prev_actions.clone()

    assert env.toggle_random_actions() is True
    obs_a, act_a = run()
    obs_b, act_b = run()
    assert torch.equal(obs_a, obs_b) and torch.equal(act_a, act_b)
    assert float(act_a.abs().min()) > 0 and float(act_a.abs().max()) <= 1.0
    assert env.toggle_random_actions() is False
    _, act_c = run()
    assert torch.equal(act_c, torch.zeros_like(act_c))

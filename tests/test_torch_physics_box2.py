"""The port's two-box physics (`SimParams.has_box2`) held against the JAX
package (CPU).

(a) One control step of the port's plain engine against the JAX jnp engine
    (`make_control_step(1, use_pallas=False)`) from the two-cube state of
    tests/test_pallas_step.py (the pick cube resting on the platform cube,
    offset, yawed and pushed, slightly interpenetrating, the hand near), at
    <= 1e-3 relative, the JAX package's physics tolerance
    (physics/pallas_step.py:25-26); the state is checked to have cube-cube,
    platform-ground and hand contacts.
(b) The port's counterparts of tests/test_physics_multibody.py's scenarios:
    stacked cubes rest, a dropped cube lands on the platform, a side impact
    is blocked, the second box's contact force is reported, a single-box
    scene has no second box, and has_box2 requires has_box.
(c) The K2 wrapper's CPU dispatch in a two-box scene (the plain engine).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.physics import types as jt
from dexrobot_isaac_tpu.physics.engine import HandPhysics as JaxPhysics
from dexrobot_isaac_tpu_torch.physics import lane_step
from dexrobot_isaac_tpu_torch.physics import types as tt
from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics

N = 8
S1, S2 = 0.05, 0.08   # the pick cube, the platform cube
TWO_BOX = dict(has_box=True, box_size=S1, box_mass=0.1, has_box2=True, box2_size=S2,
               box2_mass=0.5)
T = torch.as_tensor


def _stacked_inputs():
    """tests/test_pallas_step.py's pushed stack, per env a little offset,
    with the fingers flexed and moving over the cubes."""
    rng = np.random.default_rng(0)
    f = lambda x: np.asarray(x, np.float32)
    yaw = 0.2
    q = np.zeros((N, 26), np.float32)
    q[:, 6:] = rng.uniform(0.0, 0.6, (N, 20))
    state = dict(
        q=q, qd=f(rng.normal(0, 0.2, (N, 26))),
        box_pos=f(np.tile([[0.128, 0.006, 0.1035]], (N, 1))
                  + np.c_[rng.normal(0, 0.003, (N, 2)), np.zeros(N)]),
        box_quat=f(np.tile([[0, 0, np.sin(yaw / 2), np.cos(yaw / 2)]], (N, 1))),
        box_linvel=f(np.tile([[0.05, -0.02, 0.0]], (N, 1))),
        box_angvel=f(rng.normal(0, 0.3, (N, 3))),
        box2_pos=f(np.tile([[0.12, 0.0, 0.0395]], (N, 1))),
        box2_quat=f(np.tile([[0, 0, 0, 1.0]], (N, 1))),
        box2_linvel=np.zeros((N, 3), np.float32), box2_angvel=np.zeros((N, 3), np.float32))
    targets = f(q + rng.normal(0, 0.1, (N, 26)))
    spawn = f(np.tile([[0.04, 0.0, 0.075]], (N, 1)))
    dr = f(rng.uniform(0.8, 1.2, (4, N)))
    return state, targets, spawn, dr


@pytest.fixture(scope="module")
def two_box_step():
    state, targets, spawn, dr = _stacked_inputs()
    params = dict(dt=0.01, substeps=2, **TWO_BOX)
    je = JaxPhysics(params=jt.SimParams(**params))
    fn = jax.jit(je.make_control_step(1, use_pallas=False))
    js, jinfo, _ = jax.device_get(fn(
        jt.PhysicsState(**{k: jnp.asarray(v) for k, v in state.items()}), jnp.asarray(targets),
        jnp.asarray(spawn), jt.DRSample(*map(jnp.asarray, dr))))
    te = HandPhysics(params=tt.SimParams(**params), device="cpu")
    st = tt.PhysicsState(**{k: T(v) for k, v in state.items()})
    ts, tinfo, _ = te.plain_control_step(1)(st, T(targets), T(spawn), tt.DRSample(*map(T, dr)))
    return te, st, tt.DRSample(*map(T, dr)), js, jinfo, ts, tinfo


def test_two_box_state_has_every_contact(two_box_step):
    te, st, dr, _, jinfo, _, _ = two_box_step
    p = te.params
    box = (st.box_pos, st.box_quat, st.box_linvel, st.box_angvel)
    box2 = (st.box2_pos, st.box2_quat, st.box2_linvel, st.box2_angvel)
    bm, bi = p.box_mass * dr.box_mass_scale, te.box_inertia * dr.box_mass_scale
    b2m, b2i = p.box2_mass * dr.box_mass_scale, te.box2_inertia * dr.box_mass_scale
    fa, _, fb, _ = te._box_box(box, box2, S1 / 2, bm, bi, S2 / 2, b2m, b2i, torch.ones(N, 1))
    assert bool((fa.abs().sum(1) > 0).all()) and torch.allclose(fa, -fb, atol=1e-4)
    assert bool((np.abs(jinfo.body_contact_force).sum((1, 2)) > 0).any())
    assert bool((np.abs(jinfo.box2_contact_force).sum(1) > 0).all())


@pytest.mark.parametrize("key", ["q", "qd", "box_pos", "box_quat", "box_linvel", "box_angvel",
                                 "box2_pos", "box2_quat", "box2_linvel", "box2_angvel"])
def test_two_box_state_matches_jax(two_box_step, key):
    *_, js, _, ts, _ = two_box_step
    want, got = getattr(js, key), getattr(ts, key).numpy()
    assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("key", ["body_contact_force", "box_contact_force",
                                 "box2_contact_force"])
def test_two_box_forces_match_jax(two_box_step, key):
    *_, jinfo, _, tinfo = two_box_step
    want, got = getattr(jinfo, key), getattr(tinfo, key).numpy()
    assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(), 1e-6)


# ---------------------------------------------------------------- (b) scenarios
@pytest.fixture(scope="module")
def engine():
    return HandPhysics(params=tt.SimParams(**TWO_BOX), device="cpu")


def _state(box_pos, box2_pos, box_linvel=(0.0, 0.0, 0.0)):
    quat = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    z3 = torch.zeros(1, 3)
    return tt.PhysicsState(q=torch.zeros(1, 26), qd=torch.zeros(1, 26),
                           box_pos=torch.tensor([box_pos]), box_quat=quat,
                           box_linvel=torch.tensor([box_linvel]), box_angvel=z3,
                           box2_pos=torch.tensor([box2_pos]), box2_quat=quat.clone(),
                           box2_linvel=z3.clone(), box2_angvel=z3.clone())


def _run(engine, state, n_steps):
    """`n_steps` physics steps with the hand far above the scene, so that
    only box-box and ground contacts act."""
    step = engine.plain_control_step(n_steps)
    out, info, _ = step(state, torch.zeros(1, 26), torch.tensor([[0.0, 0.0, 1.0]]),
                        tt.DRSample.nominal(1, "cpu"))
    return out, info


def test_stacked_cubes_rest(engine):
    out, _ = _run(engine, _state([0.3, 0.0, S2 + S1 / 2], [0.3, 0.0, S2 / 2]), 100)
    assert float(out.box_pos[0, 2]) == pytest.approx(S2 + S1 / 2, abs=0.004)
    assert float(out.box2_pos[0, 2]) == pytest.approx(S2 / 2, abs=0.004)
    np.testing.assert_allclose(out.box_pos[0, :2].numpy(), [0.3, 0.0], atol=2e-3)
    assert float(torch.linalg.vector_norm(out.box_linvel)) < 0.05
    assert float(torch.linalg.vector_norm(out.box2_linvel)) < 0.05


def test_dropped_cube_lands_on_platform(engine):
    out, _ = _run(engine, _state([0.3, 0.0, 0.2], [0.3, 0.0, S2 / 2]), 300)
    z = float(out.box_pos[0, 2])
    assert S2 + S1 / 2 - 0.01 < z < S2 + S1 / 2 + 0.01
    assert float(torch.linalg.vector_norm(out.box_linvel)) < 0.05


def test_side_impact_blocks_cube(engine):
    out, _ = _run(engine, _state([0.2, 0.0, S1 / 2], [0.3, 0.0, S2 / 2], (1.5, 0.0, 0.0)), 100)
    assert float(out.box_pos[0, 0]) < 0.3 - (S1 + S2) / 2 + 0.01
    assert float(out.box_pos[0, 2]) < S2
    assert abs(float(out.box_linvel[0, 0])) < 0.2
    assert float(out.box2_pos[0, 2]) == pytest.approx(S2 / 2, abs=0.005)
    assert abs(float(out.box2_pos[0, 0]) - 0.3) < 0.05


def test_box2_contact_force_reported(engine):
    _, info = _run(engine, _state([0.3, 0.0, S2 + S1 / 2 - 0.01], [0.3, 0.0, S2 / 2]), 1)
    assert info.box2_contact_force is not None and info.box2_contact_force.shape == (1, 3)
    assert float(info.box_contact_force[0, 2]) > 0.0


def test_single_box_scene_untouched():
    eng = HandPhysics(params=tt.SimParams(has_box=True, box_size=S1, box_mass=0.1), device="cpu")
    quat = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    st = tt.PhysicsState(torch.zeros(1, 26), torch.zeros(1, 26), torch.tensor([[0.3, 0.0, S1 / 2]]),
                         quat, torch.zeros(1, 3), torch.zeros(1, 3))
    out, info, _ = eng.plain_control_step(1)(st, torch.zeros(1, 26),
                                              torch.tensor([[0.0, 0.0, 1.0]]),
                                              tt.DRSample.nominal(1, "cpu"))
    assert out.box2_pos is None and info.box2_contact_force is None
    assert float(out.box_pos[0, 2]) == pytest.approx(S1 / 2, abs=1e-3)


def test_has_box2_requires_has_box():
    with pytest.raises(ValueError):
        HandPhysics(params=tt.SimParams(has_box=False, has_box2=True), device="cpu")


# ---------------------------------------------------------------- (c) dispatch
def test_k2_wrapper_runs_the_plain_engine_on_cpu(two_box_step):
    te, st, dr, *_ = two_box_step
    state, targets, spawn, _ = _stacked_inputs()
    assert lane_step.build_name(te) == "control_step_box2"
    got, info, _ = te.make_control_step(1)(st, T(targets), T(spawn), dr)
    want, winfo, _ = te.plain_control_step(1)(st, T(targets), T(spawn), dr)
    assert torch.equal(got.box2_pos, want.box2_pos)
    assert torch.equal(info.box2_contact_force, winfo.box2_contact_force)

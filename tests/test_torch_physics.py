"""The port's plain physics engine held against the JAX jnp engine (CPU).

One physics step (`SimParams(dt=0.01, substeps=2, has_box=True)`, N=8) from
seeded random contact-rich states through `HandPhysics.make_control_step(1,
use_pallas=False)` and the port's `plain_control_step`, at <= 1e-3 relative
(each quantity's max error over its max magnitude), the JAX package's own
kernel-vs-engine physics tolerance (physics/pallas_step.py:25-26). Also the
plain `min_site_z` against the JAX lane `build_lane_sim(...).min_site_z`,
the build-time model analysis, and the K2 wrapper's CPU dispatch.

The Coriolis step (`SimParams.coriolis`): the JAX engine's
`make_control_step` against the port's (the engine's ops with the SPD solve
`linalg.spd_solve`, K3 on the card, its plain version here) from the same
state, at the same 1e-3 relative; the bias is checked to move the state by
more than that tolerance, so the comparison is not vacuous.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.physics import types as jt
from dexrobot_isaac_tpu.physics.engine import HandPhysics as JaxPhysics
from dexrobot_isaac_tpu.physics.pallas_step import build_lane_sim
from dexrobot_isaac_tpu_torch.ops import linalg
from dexrobot_isaac_tpu_torch.physics import lane_step
from dexrobot_isaac_tpu_torch.physics import types as tt
from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics as TorchPhysics

N = 8
PARAMS = dict(dt=0.01, substeps=2, has_box=True)
REL_TOL = 1e-3


def _run_both(je, te, use_port_control_step=False):
    """One control step of `je` (jnp engine) and `te` (the port's plain
    step, or its `make_control_step`) from `_inputs()`, as numpy dicts."""
    state, targets, spawn, dr = _inputs()
    fn = jax.jit(je.make_control_step(1, use_pallas=False))
    js, jinfo, jkin = jax.device_get(fn(
        jt.PhysicsState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jnp.asarray(targets), jnp.asarray(spawn), jt.DRSample(*map(jnp.asarray, dr))))
    T = torch.as_tensor
    step = te.make_control_step(1) if use_port_control_step else te.plain_control_step(1)
    ts, tinfo, tkin = step(tt.PhysicsState(**{k: T(v) for k, v in state.items()}), T(targets),
                           T(spawn), tt.DRSample(*map(T, dr)))
    kin_keys = ("body_pos", "body_quat", "body_linvel", "body_angvel", "dof_axis_w",
                "dof_origin_w", "site_pos", "site_quat")
    return dict(
        jax={**{k: getattr(js, k) for k in state}, "cf": jinfo.body_contact_force,
             "box_force": jinfo.box_contact_force, **{k: getattr(jkin, k) for k in kin_keys}},
        torch={**{k: getattr(ts, k).numpy() for k in state},
               "cf": tinfo.body_contact_force.numpy(),
               "box_force": tinfo.box_contact_force.numpy(),
               **{k: getattr(tkin, k).numpy() for k in kin_keys}},
    )


def _inputs():
    rng = np.random.default_rng(0)
    m = JaxPhysics().model
    q = (rng.uniform(m.lower_limit, m.upper_limit, (N, 26)) * 0.5).astype(np.float32)
    q[:, 0:3] = rng.uniform(-0.05, 0.05, (N, 3))
    q[:, 3:6] = rng.uniform(-0.3, 0.3, (N, 3))
    yaw = rng.uniform(-1, 1, N)
    f = lambda x: np.asarray(x, np.float32)
    state = dict(
        q=q, qd=f(rng.normal(0, 0.3, (N, 26))),
        box_pos=f(np.concatenate([rng.uniform(0.03, 0.1, (N, 2)), np.full((N, 1), 0.024)], 1)),
        box_quat=f(np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], 1)),
        box_linvel=f(rng.normal(0, 0.05, (N, 3))), box_angvel=f(rng.normal(0, 0.5, (N, 3))),
    )
    targets = f(q + rng.normal(0, 0.1, (N, 26)))
    spawn = np.tile(np.array([[0, 0, 0.1]], np.float32), (N, 1))  # hand near the ground
    dr = f(rng.uniform(0.8, 1.2, (4, N)))
    return state, targets, spawn, dr


@pytest.fixture(scope="module")
def engines():
    return JaxPhysics(params=jt.SimParams(**PARAMS)), TorchPhysics(params=tt.SimParams(**PARAMS), device="cpu")


@pytest.fixture(scope="module")
def one_step(engines):
    return _run_both(*engines)


QUANTITIES = ["q", "qd", "box_pos", "box_quat", "box_linvel", "box_angvel", "cf", "box_force",
              "body_pos", "body_quat", "body_linvel", "body_angvel", "dof_axis_w",
              "dof_origin_w", "site_pos", "site_quat"]


@pytest.mark.parametrize("name", QUANTITIES)
def test_plain_control_step_matches_jnp_engine(one_step, name):
    want, got = np.asarray(one_step["jax"][name]), one_step["torch"][name]
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale <= REL_TOL


def test_states_are_contact_rich(one_step):
    cf = np.asarray(one_step["jax"]["cf"])
    assert np.all(np.abs(cf).sum(axis=(1, 2)) > 0)
    assert np.all(np.abs(np.asarray(one_step["jax"]["box_force"])).sum(axis=1) > 0)


def test_model_analysis_matches_jax(engines):
    je, te = engines
    np.testing.assert_array_equal(te.np["sphere_meff"], je._sphere_meff)
    np.testing.assert_array_equal(te.sc_i, je._sc_i)
    np.testing.assert_array_equal(te.sc_j, je._sc_j)
    np.testing.assert_array_equal(te.np["sc_rsum"], je._sc_rsum)
    np.testing.assert_array_equal(te.np["sc_meff"], je._sc_meff)
    np.testing.assert_array_equal(te.anc_np, je._anc_body)


def test_min_site_z_matches_jax_lane_sim(engines):
    je, te = engines
    rng = np.random.default_rng(1)
    q = (rng.uniform(je.model.lower_limit, je.model.upper_limit, (64, 26))).astype(np.float32)
    q[:, 0:3] = rng.uniform(-0.2, 0.2, (64, 3))
    spawn = (0.0, 0.0, 0.25)
    tips = [0, 2, 4, 6, 8]
    sim = build_lane_sim(je, 1)
    lanes = tuple(jnp.asarray(q[:, i]) for i in range(26))
    want = np.asarray(sim.min_site_z(lanes, spawn, jnp.zeros(64, jnp.float32), np.asarray(tips)))
    got = lane_step.min_site_z(te, torch.as_tensor(q), torch.tensor(spawn), tips).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_control_step_wrapper_runs_plain_on_cpu(engines):
    _, te = engines
    state, targets, spawn, dr = _inputs()
    T = torch.as_tensor
    st = tt.PhysicsState(**{k: T(v) for k, v in state.items()})
    args = (st, T(targets), T(spawn), tt.DRSample(*map(T, dr)))
    a = lane_step.build_control_step(te, 2)(*args)
    b = te.plain_control_step(2)(*args)
    assert torch.equal(a[0].q, b[0].q) and torch.equal(a[1].body_contact_force,
                                                       b[1].body_contact_force)
    with pytest.raises(ValueError):
        lane_step.check_rows(T(targets).t().contiguous(), 26, N)  # a CPU tensor is no operand


def test_kernel_refuses_operands_off_the_engine_device(engines):
    """The kernels read the model buffer through a raw pointer, so operands
    on another device than the engine's raise before any launch."""
    _, te = engines
    with pytest.raises(ValueError, match="engine and its model buffer on cpu"):
        lane_step.model_buffer(te, 2, None, torch.device("cuda", 0))


# ---------------------------------------------------------------- Coriolis
@pytest.fixture(scope="module")
def coriolis_step():
    return _run_both(JaxPhysics(params=jt.SimParams(**PARAMS, coriolis=True)),
                     TorchPhysics(params=tt.SimParams(**PARAMS, coriolis=True), device="cpu"),
                     use_port_control_step=True)


@pytest.mark.parametrize("name", QUANTITIES)
def test_coriolis_control_step_matches_jnp_engine(coriolis_step, name):
    want, got = np.asarray(coriolis_step["jax"][name]), coriolis_step["torch"][name]
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale <= REL_TOL


@pytest.mark.parametrize("name", ["q", "qd"])
def test_coriolis_bias_exceeds_the_tolerance(coriolis_step, one_step, name):
    on, off = np.asarray(coriolis_step["jax"][name]), np.asarray(one_step["jax"][name])
    assert float(np.abs(on - off).max()) / float(np.abs(on).max()) > 2 * REL_TOL


def test_coriolis_step_solves_through_spd_solve(monkeypatch):
    """The Coriolis control step sends every substep's system to
    `linalg.spd_solve` (K3 on the card), never straight to torch.linalg;
    the plain step keeps the plain solve."""
    calls = []

    def counted(A, b):
        calls.append(A.device)
        return linalg.spd_solve_plain(A, b)

    monkeypatch.setattr(linalg, "spd_solve", counted)
    te = TorchPhysics(params=tt.SimParams(**PARAMS, coriolis=True), device="cpu")
    state, targets, spawn, dr = _inputs()
    T = torch.as_tensor
    args = (tt.PhysicsState(**{k: T(v) for k, v in state.items()}), T(targets), T(spawn),
            tt.DRSample(*map(T, dr)))
    te.make_control_step(2)(*args)
    assert len(calls) == 2 * PARAMS["substeps"]
    te.plain_control_step(2)(*args)
    assert len(calls) == 2 * PARAMS["substeps"]

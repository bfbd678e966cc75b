"""The JAX package's side of `tests/test_torch_measure_tools.py`, run in
subprocesses beside the port's tests, one per part (each prints one JSON
line):

- "count": FLOPs per env step of the JAX BlindGrasping step at 8 envs,
  1 substep x 1 physics step, by XLA's `HloCostAnalysis` of the lowered
  program (`jax.jit(env.step_fn).lower(...).cost_analysis()`, as
  `tools/count_flops.py` counts but before XLA's optimizations);
- "coriolis <scale>": `tools/measure_coriolis.py`'s sweep over `SWEEP_S` seconds at
  one velocity scale, its instantaneous |dqd| and |Q_bias| maxima and
  closed-loop |dq| maximum, unrounded: the tool's own loop, without its
  fingertip deltas.

    JAX_PLATFORMS=cpu python -m tests.torch_measure_jax count
    JAX_PLATFORMS=cpu python -m tests.torch_measure_jax coriolis <scale>
"""

import dataclasses
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

SWEEP_S = 0.2


def count_1x1() -> float:
    from dexrobot_isaac_tpu.factory import make_env
    from dexrobot_isaac_tpu.utils.config import load_config

    n = 8
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={n}", "sim.substeps=1",
                                "sim.physics_steps_per_control=1"]))
    state_t, _ = jax.eval_shape(env.reset_fn, jax.random.key(0))
    acts_t = jax.ShapeDtypeStruct((n, env.num_actions), jnp.float32)
    ca = jax.jit(env.step_fn).lower(state_t, acts_t).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"]) / n


def coriolis(scale: float, seconds: float = SWEEP_S) -> dict:
    from dexrobot_isaac_tpu.constants import NUM_BASE_DOFS, NUM_DOFS
    from dexrobot_isaac_tpu.physics.engine import HandPhysics
    from dexrobot_isaac_tpu.physics.types import SimParams, make_initial_physics_state

    params = SimParams(has_box=False)
    eng_off = HandPhysics(params=params)
    eng_on = HandPhysics(model=eng_off.model, params=dataclasses.replace(params, coriolis=True))
    lower, upper = np.asarray(eng_off._lower), np.asarray(eng_off._upper)
    span_lo, span_hi = lower.copy(), upper.copy()
    span_lo[0:2], span_hi[0:2] = -0.15, 0.15
    span_lo[2], span_hi[2] = 0.0, 0.2
    span_lo[3:6], span_hi[3:6] = -0.8, 0.8
    mid = 0.5 * (span_lo + span_hi)
    amp = 0.5 * (span_hi - span_lo) * 0.98
    vmax = np.empty(NUM_DOFS, np.float32)
    vmax[:3] = 0.5
    vmax[3:NUM_BASE_DOFS] = 1.5
    vmax[NUM_BASE_DOFS:] = 1.0
    dt = params.dt
    n_steps = int(round(seconds / dt))
    spawn = jnp.asarray([0.0, 0.0, 0.6], jnp.float32)

    def targets_at(t, scale):
        w = vmax * scale / np.maximum(amp, 1e-6)
        return (mid + amp * np.sin(w * t - np.pi / 2)).astype(np.float32)

    step_off = jax.jit(lambda s, tgt: eng_off.step_single(s, tgt, spawn)[0])
    step_on = jax.jit(lambda s, tgt: eng_on.step_single(s, tgt, spawn)[0])

    def bias_torque(state):
        kin = eng_on.fk(state.q, state.qd, spawn)
        S = eng_on._motion_subspace(kin)
        i_o = eng_on._spatial_inertia_o(kin)
        omega = kin.body_angvel
        v_o = kin.body_linvel - jnp.cross(omega, kin.body_pos)
        v6 = jnp.concatenate([omega, v_o], axis=-1)
        h = jnp.einsum("bij,bj->bi", i_o, v6)
        p_bias = jnp.concatenate(
            [jnp.cross(omega, h[:, :3]) + jnp.cross(v_o, h[:, 3:]),
             jnp.cross(omega, h[:, 3:])], axis=-1)
        return jnp.sum(S * (eng_on._anc_body @ p_bias), axis=-1)

    bias_jit = jax.jit(bias_torque)
    base = make_initial_physics_state(1)
    base = jax.tree.map(lambda x: x[0], base)
    s_off = s_on = dataclasses.replace(base, q=jnp.asarray(targets_at(0.0, scale)))
    dqd, bias, dq = [], [], []
    for k in range(n_steps):
        tgt = jnp.asarray(targets_at((k + 1) * dt, scale))
        probe_on = step_on(s_off, tgt)
        s_off = step_off(s_off, tgt)
        s_on = step_on(s_on, tgt)
        if (k + 1) % 5 == 0:
            dqd.append(np.abs(np.asarray(probe_on.qd - s_off.qd)).max())
            bias.append(np.abs(np.asarray(bias_jit(s_off))).max())
            dq.append(np.abs(np.asarray(s_on.q - s_off.q)).max())
    return {"dqd_max": float(max(dqd)), "bias_max": float(max(bias)), "dq_max": float(max(dq))}


if __name__ == "__main__":
    part = sys.argv[1]
    out = count_1x1() if part == "count" else coriolis(float(sys.argv[2]))
    print(json.dumps(out), flush=True)

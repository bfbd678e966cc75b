"""Measure the velocity-product (Coriolis/centrifugal) dynamics omission (the
port of `tools/measure_coriolis.py`).

The reference's L0 is PhysX's full articulated solver, which includes the
velocity-product terms. The engine omits them by default; `SimParams.
coriolis=True` adds the RNEA bias wrench v x* (I_o v) (`physics/engine.py`
`_substep`). Two measurements, on a contact-free aerial sweep (contact and
joint-limit clipping make long-horizon deltas chaotic):

  1. INSTANTANEOUS: along the baseline (Coriolis off) trajectory, step the
     same state through both dynamics and compare one physics step of qd:
     the direct magnitude of the omitted term. Also the generalized bias
     torque |Q_bias| on the same states.
  2. TRAJECTORY: closed-loop q and fingertip divergence over the sweep (PD
     tracking is contractive, so this stays finite without contact).

The sweep drives all DOF targets sinusoidally at the task-commanded velocity
limits (fingers 1.0 rad/s, base linear 0.5 m/s, base angular 1.5 rad/s) and
at 3x, from the target pose, the hand base high enough that nothing touches
the ground. Both dynamics run the engine's ops with `ops/linalg.py`
`spd_solve`, so on the card every substep solves through the SPD-solve
kernel K3, and the two runs differ by the bias alone. The two velocity
scales run side by side as two envs of one batch (each env's arithmetic is
its own).

    python -m dexrobot_isaac_tpu_torch.tools.measure_coriolis [seconds] [device=cpu]
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.utils.device import resolve_device, split_device

SCALES = ((1.0, "commanded-limit"), (3.0, "3x stress"))


def run(seconds: float = 4.0, device="cuda") -> Dict[str, Dict[str, float]]:
    """Prints the two measurements for each scale and returns them: {label:
    {"qd_peak", "dqd_max", "dqd_p50", "bias_max", "dq_max", "tip_mm"}}."""
    from dexrobot_isaac_tpu_torch.constants import NUM_BASE_DOFS, NUM_DOFS
    from dexrobot_isaac_tpu_torch.ops import linalg
    from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics, _cross
    from dexrobot_isaac_tpu_torch.physics.types import DRSample, PhysicsState, SimParams

    dev = resolve_device(device)
    params = SimParams(has_box=False)
    eng_off = HandPhysics(params=params, device=dev)
    eng_on = HandPhysics(model=eng_off.model, params=dataclasses.replace(params, coriolis=True),
                         device=dev)

    lower, upper = eng_off.np["lower"], eng_off.np["upper"]
    span_lo, span_hi = lower.copy(), upper.copy()
    # base DOFs are unlimited: a bounded aerial sweep (base z only upward, so
    # the fingers never reach the ground from spawn 0.6 m)
    span_lo[0:2], span_hi[0:2] = -0.15, 0.15
    span_lo[2], span_hi[2] = 0.0, 0.2
    span_lo[3:6], span_hi[3:6] = -0.8, 0.8
    mid = 0.5 * (span_lo + span_hi)
    amp = 0.5 * (span_hi - span_lo) * 0.98
    vmax = np.empty(NUM_DOFS, np.float32)  # commanded velocity limits per DOF
    vmax[:3] = 0.5
    vmax[3:NUM_BASE_DOFS] = 1.5
    vmax[NUM_BASE_DOFS:] = 1.0

    dt = params.dt
    n_steps = int(round(seconds / dt))
    k = len(SCALES)
    spawn = torch.tensor([[0.0, 0.0, 0.6]], device=dev).expand(k, 3)
    dr = DRSample.nominal(k, dev)

    def targets_at(t):
        # sinusoid with peak target speed = scale * commanded max velocity
        rows = [(mid + amp * np.sin(vmax * s / np.maximum(amp, 1e-6) * t - np.pi / 2))
                .astype(np.float32) for s, _ in SCALES]
        return torch.as_tensor(np.stack(rows), device=dev)

    ops_off = eng_off._op_control_step(1, linalg.spd_solve)
    ops_on = eng_on._op_control_step(1, linalg.spd_solve)
    step_off = lambda s, tgt: ops_off(s, tgt, spawn, dr)
    step_on = lambda s, tgt: ops_on(s, tgt, spawn, dr)

    def bias_torque(state):
        kin = eng_on.fk(state.q, state.qd, spawn)
        S = eng_on._motion_subspace(kin)
        i_o = eng_on._spatial_inertia_o(kin)
        omega = kin.body_angvel
        v_o = kin.body_linvel - _cross(omega, kin.body_pos)
        h = torch.einsum("nbij,nbj->nbi", i_o, torch.cat([omega, v_o], -1))
        p_bias = torch.cat([_cross(omega, h[..., :3]) + _cross(v_o, h[..., 3:]),
                            _cross(omega, h[..., 3:])], -1)
        return (S * torch.einsum("bc,nck->nbk", eng_on.t["anc"], p_bias)).sum(-1)

    z = lambda w: torch.zeros(k, w, device=dev)
    quat = z(4)
    quat[:, 3] = 1.0
    s_off = s_on = PhysicsState(q=targets_at(0.0), qd=z(NUM_DOFS), box_pos=z(3), box_quat=quat,
                                box_linvel=z(3), box_angvel=z(3))
    rec = {key: [] for key in ("dqd", "bias", "qd", "dq", "tip")}
    amax = lambda x: x.abs().reshape(k, -1).amax(1).cpu().numpy()
    print(f"# {n_steps} physics steps x {params.substeps} substeps, dt={dt}s ({seconds}s "
          f"simulated), aerial sweep (no contact), on {dev.type}", flush=True)
    with torch.no_grad():
        for i in range(n_steps):
            tgt = targets_at((i + 1) * dt)
            # instantaneous: both dynamics from the SAME baseline state
            probe_on = step_on(s_off, tgt)[0]
            s_off, _, kin_off = step_off(s_off, tgt)
            s_on, _, kin_on = step_on(s_on, tgt)
            if (i + 1) % 5 == 0:
                rec["dqd"].append(amax(probe_on.qd - s_off.qd))
                rec["bias"].append(amax(bias_torque(s_off)))
                rec["qd"].append(amax(s_off.qd))
                rec["dq"].append(amax(s_on.q - s_off.q))
                rec["tip"].append(torch.linalg.norm(kin_on.site_pos - kin_off.site_pos,
                                                    dim=-1).amax(1).cpu().numpy())
    out = {}
    for j, (scale, label) in enumerate(SCALES):
        col = {key: np.asarray(v)[:, j] for key, v in rec.items()}
        r = out[label] = {
            "qd_peak": float(col["qd"].max()), "dqd_max": float(col["dqd"].max()),
            "dqd_p50": float(np.percentile(col["dqd"], 50)), "bias_max": float(col["bias"].max()),
            "dq_max": float(col["dq"].max()), "tip_mm": float(col["tip"].max() * 1000)}
        print(f"[{label}] {scale}x commanded velocity limits "
              f"(peak |qd| seen {r['qd_peak']:.2f} rad/s):")
        print(f"  instantaneous per-step |dqd|: max {r['dqd_max']:.2e} rad/s, "
              f"p50 {r['dqd_p50']:.2e}")
        print(f"  bias torque |Q_bias|: max {r['bias_max']:.2e} N*m")
        print(f"  closed-loop traj: max |dq| {r['dq_max']:.2e} rad, "
              f"max tip delta {r['tip_mm']:.4f} mm", flush=True)
    return out


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    run(float(pos[0]) if pos else 4.0, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

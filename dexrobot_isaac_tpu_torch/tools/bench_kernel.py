"""Micro-benchmark of the lane-physics control step K2 alone (the port of
`tools/bench_kernel.py`).

    python -m dexrobot_isaac_tpu_torch.tools.bench_kernel [num_envs] [steps] [n1,n2,...]
        [device=cpu]

Times only the physics control step (no observations, rewards or PPO):
`physics/lane_step.py` `build_control_step` over `csrc/control_step.cu`,
the JAX tool's setup: `SimParams(dt=0.01, substeps=2, has_box=True)`, 4
physics steps per call, q jittered by U(0, 0.2) and the box at (0.1, 0,
0.027). One JSON line per configuration: `steps` calls chained on the state
each returns, on the host clock with the card synchronized after them, and
each call's device ms from launches queued behind a sleeping kernel
(`kernel_build.device_ms`, so the host's launch overhead stays out).

The JAX tool sweeps its `ENV_BLOCK`; K2's envs per block are fixed by its
half-warp design (8), so the third argument sweeps env counts instead
(default: `num_envs` alone), and each line carries the launch's envs per
block. On the CPU the wrapper runs the plain engine, which has no blocks and
no device time (both null).
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Sequence

import torch

from dexrobot_isaac_tpu_torch.utils.device import (
    card_name,
    resolve_device,
    split_device,
    synchronize,
)


def run(counts: Sequence[int] = (4096,), steps: int = 50, device="cuda") -> List[dict]:
    """Prints and returns one line per env count."""
    from dexrobot_isaac_tpu_torch.physics import lane_step
    from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics
    from dexrobot_isaac_tpu_torch.physics.types import DRSample, PhysicsState, SimParams
    from dexrobot_isaac_tpu_torch.utils import kernel_build as kb

    dev = resolve_device(device)
    card = card_name(dev)
    phys = HandPhysics(params=SimParams(dt=0.01, substeps=2, has_box=True), device=dev)
    n_physics_steps = 4
    ctrl = lane_step.build_control_step(phys, n_physics_steps)
    on_card = dev.type == "cuda"
    envs_per_block = lane_step.shared_layout(kb.load("control_step"))[2] if on_card else None
    lines = []
    for n in counts:
        gen = torch.Generator(device=dev).manual_seed(0)
        z = lambda k: torch.zeros(n, k, device=dev)
        q = torch.rand(n, 26, generator=gen, device=dev) * 0.2
        quat = z(4)
        quat[:, 3] = 1.0
        state = PhysicsState(q=q, qd=z(26), box_pos=torch.tensor([[0.1, 0.0, 0.027]],
                                                                 device=dev).expand(n, 3),
                             box_quat=quat, box_linvel=z(3), box_angvel=z(3))
        spawn = torch.tensor([[0.0, 0.0, 0.25]], device=dev).expand(n, 3)
        dr = DRSample.nominal(n, dev)
        t0 = time.perf_counter()
        ctrl(state, q, spawn, dr)
        synchronize(dev)
        warm_s = time.perf_counter() - t0
        s = state
        t0 = time.perf_counter()
        for _ in range(steps):
            s = ctrl(s, q, spawn, dr)[0]
        synchronize(dev)
        dt = time.perf_counter() - t0
        ms = kb.device_ms(lambda: ctrl(state, q, spawn, dr), steps) if on_card else None
        line = {
            "metric": f"kernel env-steps/s ({n} envs, " + (
                f"{envs_per_block} envs per block)" if on_card else "the plain engine)"),
            "value": round(n * steps / dt, 1),
            "unit": "env-steps/s",
            "substeps_per_call": n_physics_steps * phys.params.substeps,
            "warmup_s": round(warm_s, 1),
            "envs_per_block": envs_per_block,
            "device_ms_per_launch": ms,
            "card": card,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    n = int(pos[0]) if pos else 4096
    counts = [int(c) for c in pos[2].split(",")] if len(pos) > 2 else [n]
    run(counts, int(pos[1]) if len(pos) > 1 else 50, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headline benchmark of the port: BlindGrasping env throughput on one card
(the port of `bench.py`).

    python -m dexrobot_isaac_tpu_torch.bench [num_envs] [steps] [device=cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"median_of_5", "flops_per_env_step", "achieved_flops_per_s", "mfu",
"f32_mfu"}.

Metric: env-steps/s on one card at `num_envs` envs (default 4096) of
BlindGrasping, each env step one full control step (action pipeline -> 4
physics steps x 4 substeps -> observations, rewards, termination -> masked
auto-reset). Two step paths are timed, interleaved within each of 5
repetitions, and the best window of the faster path wins:
  - "fused": K1, the whole control step as one kernel
    (`DexHandEnv.make_fused().step_fn`), the training path;
  - "unfused": the env's `step_fn`, the physics in K2 and the rest in eager
    torch ops, the evaluation path (the JAX bench's "xla").
DEXHAND_BENCH_PATH=unfused|fused|best (default best) restricts them. On the
card both paths run by default and a failure of either raises: there is no
fallback. A window is the host clock around `steps` chained steps (rounded
to chunks of 16), each on the state the last one returned, ending in a
synchronize of the card; one chunk per path warms up first. One step of
each path outside the windows is the finiteness probe.

The baseline is the JAX bench's: 4096 envs x 60 steps/s = 245,760
env-steps/s, the reference's "thousands of parallel hands at 60+ FPS on a
single GPU" (docs/DESIGN_DECISIONS.md:166). `flops_per_env_step` is the
plain step's semantic count (`tools/count_flops.py`, every substep counted),
`mfu` the achieved rate over the H100 SXM's 989.4 TFLOP/s of dense BF16
tensor-core math (the usual MFU denominator) and `f32_mfu` over its 67
TFLOP/s of f32 outside the tensor cores, the peak that binds this f32 lane
math. stderr carries each path's rate with the card's name and power limit,
and the kernels' launches over the warm-up and the windows.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Sequence

import torch

from dexrobot_isaac_tpu_torch.tools.roofline import H100_BF16_DENSE_PER_S, H100_F32_PER_S
from dexrobot_isaac_tpu_torch.utils.device import (
    card_name,
    resolve_device,
    split_device,
    synchronize,
)

CHUNK = 16
REPS = 5
BASELINE = 245760.0  # 4096 envs x 60 FPS, docs/DESIGN_DECISIONS.md:166 (JAX bench.py:136)


def run(num_envs: int = 4096, steps: int = 50, device="cuda", path=None,
        quiet: bool = False, overrides: Sequence[str] = ()) -> Dict:
    """Times the paths; returns {"line": the JSON line's dict, "per_path":
    best env-steps/s by path, "median": by path, "launches": the kernels'
    launches over the warm-up and the windows, "steps": per window}.
    Prints the line and the stderr report unless `quiet` (then the FLOP
    count is skipped and the line holds the rates only). `overrides` are
    config keys on top of the task's, for the timed step and its count
    alike (the CPU tests cut the substeps)."""
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.tools import count_flops
    from dexrobot_isaac_tpu_torch.utils import kernel_build as kb
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    dev = resolve_device(device)
    path = path or os.environ.get("DEXHAND_BENCH_PATH", "best")
    if path not in ("best", "fused", "unfused"):
        raise ValueError(f"DEXHAND_BENCH_PATH={path!r}: one of best, fused, unfused")
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={num_envs}", *overrides]),
                   seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    actions = torch.rand(num_envs, env.num_actions, generator=gen, device=dev) * 2 - 1

    # path -> [step_fn, carried state]
    runners = {}
    if path in ("best", "fused"):
        fused = env.make_fused()
        runners["fused"] = [fused.step_fn, fused.reset()[0]]
    if path in ("best", "unfused"):
        runners["unfused"] = [env.step_fn, env.reset_fn()[0]]

    n_chunks = max(1, steps // CHUNK)
    steps = n_chunks * CHUNK

    def window(r, chunks):
        for _ in range(chunks * CHUNK):
            r[1] = r[0](r[1], actions)[0]
        synchronize(dev)

    synchronize(dev)
    before = dict(kb.LAUNCHES)
    for r in runners.values():  # warm-up: one chunk each
        window(r, 1)
    dts = {name: [] for name in runners}
    for _ in range(REPS):  # paths interleaved, so load swings hit both
        for name, r in runners.items():
            t0 = time.perf_counter()
            window(r, n_chunks)
            dts[name].append(time.perf_counter() - t0)
    launches = {k: v - before[k] for k, v in kb.LAUNCHES.items() if v > before[k]}

    # finiteness probe, one step of each path outside the windows
    for name, (step_fn, state) in runners.items():
        _, obs, rew, _, _ = step_fn(state, actions)
        if not bool(torch.isfinite(obs).all() & torch.isfinite(rew).all()):
            raise RuntimeError(f"benchmark's {name} path produced non-finite obs/rewards")

    per_path = {n: num_envs * steps / min(d) for n, d in dts.items()}
    median = {n: num_envs * steps / sorted(d)[len(d) // 2] for n, d in dts.items()}
    winner = max(per_path, key=per_path.get)
    value = per_path[winner]
    line = {
        "metric": f"env-steps/s/chip (BlindGrasping, {num_envs} envs, {winner})",
        "value": round(value, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(value / BASELINE, 3),
        "median_of_5": round(median[winner], 1),
    }
    out = {"line": line, "per_path": per_path, "median": median, "launches": launches,
           "steps": steps}
    if quiet:
        return out
    card = card_name(dev)
    print(f"paths ({card}, best of {REPS} windows of {steps} steps): "
          + " ".join(f"{n}={v:,.0f}" for n, v in per_path.items())
          + " | medians: " + " ".join(f"{n}={v:,.0f}" for n, v in median.items()),
          file=sys.stderr)
    print(f"launches (warm-up {CHUNK} + {REPS} x {steps} steps per path): "
          f"{json.dumps(launches)}", file=sys.stderr)
    # the semantic count of the plain step on the CPU; a failure raises
    flops = count_flops.count("BlindGrasping", 8, overrides)["flops_per_env_step"]
    achieved = value * flops
    line.update({
        "flops_per_env_step": round(flops, 1),
        "achieved_flops_per_s": round(achieved, 1),
        "mfu": round(achieved / H100_BF16_DENSE_PER_S, 6),
        "f32_mfu": round(achieved / H100_F32_PER_S, 6),
    })
    print(json.dumps(line), flush=True)
    return out


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    run(int(pos[0]) if pos else 4096, int(pos[1]) if len(pos) > 1 else 50, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

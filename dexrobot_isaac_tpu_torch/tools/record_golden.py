"""Record the golden scenario's fused-step trajectory from the port's K1 (the
port of `tools/record_golden.py`).

    python -m dexrobot_isaac_tpu_torch.tools.record_golden <out.npz> [device=cpu]

The scenario is `tests/golden_scenario.py`'s (BlindGrasping, 8 envs, 6-step
episodes, 2 substeps, seed 123, 12 steps of uniform actions) with the reset
operands the JAX step drew (`dexrobot_isaac_tpu_torch/data/
golden_operands.npz`), stepped through K1 on the card, or through its plain
version with `device=cpu`. The npz has the TPU golden's keys, shapes and
dtypes (`backend` is "gpu" or "cpu"). It refuses to write over
`tests/golden/fused_blind_grasping.npz`: that file was recorded from the TPU
kernel and stays the reference the port is held to. The recording is then
held against it at the golden budgets (obs atol 2e-4, reward and components
atol 1e-3, done exact).
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.utils.device import resolve_device, split_device

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_GOLDEN = os.path.join(os.path.dirname(PKG), "tests", "golden", "fused_blind_grasping.npz")
OPERANDS = os.path.join(PKG, "data", "golden_operands.npz")
# tests/golden_scenario.py's scenario
CONFIG = ["task=BlindGrasping", "numEnvs=8", "env.episodeLength=6", "sim.substeps=2"]
SEED = 123
STEPS = 12
BUDGETS = {"obs": 2e-4, "rew": 1e-3, "comp": 1e-3}


def record(device="cuda") -> Dict[str, np.ndarray]:
    """The scenario through the fused step: {"obs", "rew", "done", "comp"},
    each stacked over the steps."""
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    dev = resolve_device(device)
    ops = {k: torch.as_tensor(v, device=dev) for k, v in np.load(OPERANDS).items()}
    env = make_env(load_config(list(CONFIG)), seed=SEED, device=dev)
    fused = env.make_fused()
    fs, _ = fused.reset(samples=(fused.reset_from_rows(ops["init_rst"]), None))
    out = {k: [] for k in ("obs", "rew", "done", "comp")}
    for t in range(STEPS):
        fs, obs, rew, done, ex = fused.step_fn(fs, ops["actions"][t],
                                               operands=(ops["rst"][t], ops["drn"][t]))
        for k, v in (("obs", obs), ("rew", rew), ("done", done),
                     ("comp", ex["reward_components_packed"])):
            out[k].append(v.cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def write(path: str, device="cuda") -> Dict[str, np.ndarray]:
    """Records into `path` (refusing the TPU golden) and returns the arrays."""
    if os.path.realpath(path) == os.path.realpath(TPU_GOLDEN) or (
            os.path.exists(path) and os.path.exists(TPU_GOLDEN)
            and os.path.samefile(path, TPU_GOLDEN)):
        raise ValueError(f"refusing to write over the TPU golden {TPU_GOLDEN}: it is the "
                         "reference the port is held to; name another path")
    out = record(device)
    backend = "gpu" if torch.device(device).type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, backend=backend, steps=STEPS, seed=SEED, **out)
    return out


def golden_errors(rec: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Max abs error of a recording against the TPU golden per key, and
    whether the done masks are equal ("done")."""
    golden = np.load(TPU_GOLDEN)
    err = {k: float(np.abs(rec[k] - golden[k]).max()) for k in BUDGETS}
    err["done"] = bool(np.array_equal(rec["done"], golden["done"]))
    return err


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    if not pos:
        print(__doc__)
        return 2
    out = write(pos[0], device)
    print(f"golden recorded: {pos[0]}")
    for k, v in out.items():
        print(f"  {k}: {v.shape} {v.dtype} |mean|={np.abs(v).mean():.4f}")
    err = golden_errors(out)
    print("against the TPU golden: done equal {}, max abs err ".format(err["done"]) + " ".join(
        f"{k} {err[k]:.3e} (atol {b:g})" for k, b in BUDGETS.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

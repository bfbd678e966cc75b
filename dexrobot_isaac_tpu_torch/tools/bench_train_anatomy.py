"""Training-iteration anatomy: where does full-PPO time go? (the port of
`tools/bench_train_anatomy.py`)

Times, at BlindGrasping on the fused step (K1), the best of 5 windows each
on the host clock with the card synchronized:
  1. env-step only (horizon_length fused steps, no policy)
  2. rollout only (act + env step, `PPOLearner._rollout`)
  3. a full `train_iteration` (rollout + GAE + update; update+GAE printed
     as the difference)
  4. `make_chunked_train_step(chunk)`, chunk iterations per call, for each
     chunk and shuffle of the arguments, best of 3 calls after one warm-up.

    python -m dexrobot_isaac_tpu_torch.tools.bench_train_anatomy [num_envs] [shuffles] [chunks]
        [device=cpu]

  num_envs  default 8192
  shuffles  comma list of minibatch shuffles to sweep (default: permutation)
  chunks    comma list of chunk depths (default: 8)
"""

from __future__ import annotations

import copy
import math
import sys
import time
from typing import Dict, Sequence

import torch

from dexrobot_isaac_tpu_torch.utils.device import (
    card_name,
    resolve_device,
    split_device,
    synchronize,
)


def run(n: int = 8192, shuffles: Sequence[str] = ("permutation",), chunks: Sequence[int] = (8,),
        device="cuda", reps: int = 5, chunk_reps: int = 3, overrides: Sequence[str] = ()) -> Dict:
    """Prints each timing's line; returns {line label: seconds}. `overrides`
    are config keys on top of the task's (the CPU tests cut substeps)."""
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.rl.ppo import PPOLearner, ppo_config_from
    from dexrobot_isaac_tpu_torch.utils.config import load_config, set_by_path

    dev = resolve_device(device)
    cfg = load_config(["task=BlindGrasping", f"numEnvs={n}", *overrides])
    env = make_env(cfg, seed=0, device=dev)
    fused = env.make_fused()

    def learner(shuffle):
        set_by_path(cfg, "train.params.config.shuffle", shuffle)
        lrn = PPOLearner(ppo_config_from(cfg, env), fused.step_fn, seed=0, device=dev)
        lrn.comp_names = tuple(fused.comp_names)
        return lrn

    lrn = learner(shuffles[0])
    ppo = lrn.init_state()
    fs, obs = fused.reset()
    T = lrn.cfg.horizon_length
    card = card_name(dev)
    print(f"# training anatomy, BlindGrasping, {n} envs, horizon {T}, fused step, {card}",
          flush=True)
    out = {}

    def best_of(fn, k=reps):
        fn()
        synchronize(dev)
        best = math.inf
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    # every timing starts from the same env state: K1 writes its rows in
    # place, so each call steps a copy
    acts = torch.zeros(n, env.num_actions, device=dev)

    def env_only():
        s = copy.deepcopy(fs)
        for _ in range(T):
            s = fused.step_fn(s, acts)[0]

    t_env = best_of(env_only)
    out["env-only"] = t_env
    print(f"env-only ({T} steps)  : {n * T / t_env:12,.0f} env-steps/s ({t_env * 1e3:7.2f} ms "
          f"/ {T} steps)", flush=True)
    t_roll = best_of(lambda: lrn._rollout(ppo, copy.deepcopy(fs), obs))
    out["rollout"] = t_roll
    print(f"rollout (act+step)  : {n * T / t_roll:12,.0f} env-steps/s ({t_roll * 1e3:7.2f} ms)",
          flush=True)
    t_full = best_of(lambda: lrn.train_iteration(ppo, copy.deepcopy(fs), obs))
    out["train_iteration"] = t_full
    print(f"train_iteration     : {n * T / t_full:12,.0f} env-steps/s ({t_full * 1e3:7.2f} ms; "
          f"update+gae = {(t_full - t_roll) * 1e3:.2f} ms)", flush=True)

    for shuffle in shuffles:
        lrn_s = lrn if shuffle == shuffles[0] else learner(shuffle)
        for chunk in chunks:
            step = lrn_s.make_chunked_train_step(chunk)
            state = (ppo, copy.deepcopy(fs), obs)
            state = step(*state)[:3]
            synchronize(dev)
            best = math.inf
            for _ in range(chunk_reps):
                t0 = time.perf_counter()
                state = step(*state)[:3]
                synchronize(dev)
                best = min(best, time.perf_counter() - t0)
            out[f"chunked x{chunk} [{shuffle}]"] = best / chunk
            print(f"chunked x{chunk} [{shuffle}]: {n * T * chunk / best:12,.0f} env-steps/s "
                  f"({best * 1e3 / chunk:7.2f} ms/iter)", flush=True)
    return out


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    run(int(pos[0]) if pos else 8192,
        (pos[1] if len(pos) > 1 else "permutation").split(","),
        [int(c) for c in (pos[2] if len(pos) > 2 else "8").split(",")], device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""PPO update anatomy: where does the update's time go? (the port of
`tools/bench_update_anatomy.py`)

    python -m dexrobot_isaac_tpu_torch.tools.bench_update_anatomy [num_envs] [device=cpu]

A near-free synthetic env (an obs-sized carry, `obs' = 0.999 obs + 0.001
sum(actions)`, 130 observations and 18 actions) makes `train_iteration`
about the rollout's MLP plus the update. The tool sweeps the update's
structural knobs, as the JAX tool does, each the best of 5 iterations on the
host clock with the card synchronized (default 8192 envs):

  - mini_epochs 1/2/4         -> per-epoch cost against the fixed cost
  - shuffle permutation/affine/rotation/perm_roll -> sort, gather and roll
  - minibatch_size 1x/2x/4x num_envs -> the minibatch loop's step overhead
  - normalize off             -> the running stats' cost

Then it splits the baseline iteration into the learner's parts, device time
between CUDA events around each (the host clock on the CPU): the rollout
(act + env step), GAE (with the bootstrap value), the moments (the running
stats' batch moments and the advantage normalization), the shuffles (the
per-iteration permutation and each epoch's reindexing and gather), the
per-minibatch forward+backward with the minibatch's KL and their all-reduce
across ranks (`PPOLearner._global_grads`) and optimizer step
(`_apply_updates`: the global-norm clip and Adam). What the parts leave out
of the iteration (the KL gate, the LR schedule, the metrics, the host's
time between the parts) is printed as the remainder. Of 5 instrumented
iterations the shortest is shown.
"""

from __future__ import annotations

import functools
import math
import sys
import time
from typing import Dict, List

import torch

from dexrobot_isaac_tpu_torch.utils.device import (
    card_name,
    resolve_device,
    split_device,
    synchronize,
)

NUM_OBS, NUM_ACTIONS = 130, 18
# (tag, PPOConfig overrides, with "mb" a multiple of num_envs): the JAX tool's ten
CONFIGS = [
    ("baseline (perm, 4 epochs, mb=num_envs)", {}),
    ("mini_epochs=1", {"mini_epochs": 1}),
    ("mini_epochs=2", {"mini_epochs": 2}),
    ("shuffle=affine", {"shuffle": "affine"}),
    ("shuffle=rotation", {"shuffle": "rotation"}),
    ("shuffle=perm_roll", {"shuffle": "perm_roll"}),
    ("minibatch=2*num_envs", {"mb": 2}),
    ("minibatch=4*num_envs", {"mb": 4}),
    ("mini_epochs=1 + affine", {"mini_epochs": 1, "shuffle": "affine"}),
    ("normalize off", {"normalize_input": False, "normalize_value": False}),
]
# (part, the learner's methods it times)
PARTS = [
    ("rollout (act + env step)", ("_rollout",)),
    ("GAE (+ bootstrap value)", ("_advantages",)),
    ("moments (stats, adv. norm)", ("_moments",)),
    ("shuffles (perm + gathers)", ("_presort", "_minibatches")),
    ("forward+backward (+ KL)", ("_global_grads",)),
    ("optimizer (clip + Adam)", ("_apply_updates",)),
]


def synthetic_step(state, actions):
    """The JAX tool's env: the observation is its own state. The actions are
    summed left to right, the order of the JAX expression's `jnp.sum` op by
    op, so the same inputs give the same bits."""
    obs = state * 0.999 + 0.001 * functools.reduce(torch.add, actions.unbind(-1))[:, None]
    done = torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)
    return obs, obs, obs[:, 0], done, {"timeout": torch.zeros_like(done)}


def _learner(n: int, dev, over: Dict):
    from dexrobot_isaac_tpu_torch.rl.ppo import PPOConfig, PPOLearner

    over = dict(over)
    if "mb" in over:
        over["minibatch_size"] = over.pop("mb") * n
    cfg = PPOConfig(num_actions=NUM_ACTIONS, num_obs=NUM_OBS, num_states=0, num_envs=n, **over)
    return PPOLearner(cfg, synthetic_step, seed=0, device=dev)


def timed(n: int, dev, over: Dict, reps: int = 5):
    """(best seconds per iteration over `reps` after one warm-up, the last
    iteration's KL)."""
    lrn = _learner(n, dev, over)
    ppo = lrn.init_state()
    obs0 = torch.ones(n, NUM_OBS, device=dev)
    ppo, st, ob, m, _ = lrn.train_iteration(ppo, obs0, obs0)
    synchronize(dev)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        ppo, st, ob, m, _ = lrn.train_iteration(ppo, st, ob)
        synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best, float(m["kl"])


class _Spans:
    """Start and end marks of calls of a learner's methods, by part."""

    def __init__(self, lrn):
        self.lrn = lrn
        self.spans: Dict[str, List] = {}

    def wrap(self, part: str, attr: str) -> None:
        fn = getattr(self.lrn, attr)

        def timed_call(*a, **k):
            s = self.lrn._mark()
            out = fn(*a, **k)
            self.spans.setdefault(part, []).append((s, self.lrn._mark()))
            return out

        setattr(self.lrn, attr, timed_call)

    def ms(self, s, e) -> float:
        return s.elapsed_time(e) if hasattr(s, "elapsed_time") else (e - s) * 1e3


def split(n: int, dev, reps: int = 5) -> Dict[str, float]:
    """The baseline iteration split into PARTS (ms), the shortest of `reps`
    instrumented iterations after a warm-up: {part: ms, "iteration": ms}."""
    lrn = _learner(n, dev, {})
    ppo = lrn.init_state()
    obs0 = torch.ones(n, NUM_OBS, device=dev)
    ppo, st, ob, _, _ = lrn.train_iteration(ppo, obs0, obs0)
    spans = _Spans(lrn)
    for part, attrs in PARTS:
        for attr in attrs:
            spans.wrap(part, attr)
    best = None
    for _ in range(reps):
        spans.spans.clear()
        t0 = lrn._mark()
        ppo, st, ob, _, _ = lrn.train_iteration(ppo, st, ob)
        t1 = lrn._mark()
        synchronize(dev)
        got = {part: sum(spans.ms(s, e) for s, e in spans.spans.get(part, ()))
               for part, _ in PARTS}
        got["iteration"] = spans.ms(t0, t1)
        if best is None or got["iteration"] < best["iteration"]:
            best = got
    return best


def run(n: int = 8192, device="cuda", reps: int = 5) -> Dict:
    """Prints each config's line and the split; returns {"configs": {tag:
    (ms, kl)}, "split": split()}."""

    dev = resolve_device(device)
    print(f"# PPO update anatomy, synthetic env ({NUM_OBS} obs, {NUM_ACTIONS} actions), {n} envs, "
          f"best of {reps} iterations, {card_name(dev)}", flush=True)
    configs = {}
    for tag, over in CONFIGS:
        best, kl = timed(n, dev, over, reps)
        configs[tag] = (best * 1e3, kl)
        print(f"{tag:42s}: {best * 1e3:7.2f} ms/iter", flush=True)
    parts = split(n, dev, reps)
    total = parts["iteration"]
    summed = sum(parts[p] for p, _ in PARTS)
    clock = "device time between CUDA events" if dev.type == "cuda" else "host clock"
    print(f"split of the baseline iteration ({clock}, the shortest of {reps}): "
          f"{total:.2f} ms", flush=True)
    for part, _ in PARTS:
        print(f"  {part:28s}: {parts[part]:8.2f} ms ({100 * parts[part] / total:5.1f}%)")
    print(f"  {'remainder':28s}: {total - summed:8.2f} ms ({100 * (total - summed) / total:5.1f}%)")
    print(f"  parts sum {summed:.2f} ms = {100 * summed / total:.1f}% of the iteration", flush=True)
    return {"configs": configs, "split": parts}


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    run(int(pos[0]) if pos else 8192, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

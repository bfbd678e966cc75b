"""Rank functions of tests/test_torch_distributed.py (not a test file).

Each runs in a process of `parallel.distributed.spawn_ranks` (a gloo group
on the CPU), reads its inputs from `<dir>/in.pt`, and writes what it found
to `<dir>/rank<r>.pt`. They import torch and the port only, so a spawned
process starts without JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from dexrobot_isaac_tpu_torch import train as cli
from dexrobot_isaac_tpu_torch.envs import termination as term_mod
from dexrobot_isaac_tpu_torch.parallel.distributed import make_sharded_env
from dexrobot_isaac_tpu_torch.parallel.mesh import init_distributed
from dexrobot_isaac_tpu_torch.rl.observer import DeviceBreakdown
from dexrobot_isaac_tpu_torch.rl.ppo import PPOConfig, PPOLearner
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd
from dexrobot_isaac_tpu_torch.utils.config import load_config


def _save(path: str, rank: int, out) -> None:
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))


def update_worker(path: str) -> None:
    """One minibatch update on this rank's slice of each case's minibatch
    (the reduced gradients and KL, the new params and Adam count), then the
    batch moments and the advantage normalization of this rank's envs."""
    group = init_distributed("cpu")
    try:
        inp = torch.load(os.path.join(path, "in.pt"))
        rows = group.shard_slice(inp["n"])
        rms = RunningMeanStd(**inp["obs_rms"])
        out = {}
        for case, (kw, mb) in inp["cases"].items():
            tl = PPOLearner(PPOConfig(**inp["small"], **kw), None, seed=0, device="cpu",
                            group=group)
            st = tl.init_state()
            mb = [x[rows] for x in mb]
            grads, kl = tl._global_grads(inp["params"], rms, mb)
            (params, opt, _, _, _, _), kl_step = tl._update_minibatch(
                (inp["params"], st.opt_state, torch.tensor(inp["lr"]), rms, st.value_rms,
                 torch.tensor(0.0)), mb)
            out[case] = dict(grads=grads, kl=kl, kl_step=kl_step, params=params,
                             count=opt.count)
        tl = PPOLearner(PPOConfig(**inp["small"]), None, seed=0, device="cpu", group=group)
        batch, adv = inp["batch"][:, rows], inp["adv"][:, rows]
        out["moments"] = tl._batch_moments(batch.reshape(-1, batch.shape[-1]))
        out["adv"] = tl._normalize_advantages(adv)
        _save(path, group.rank, out)
    finally:
        group.close()


def train_worker(path: str) -> None:
    """The CLI's training in-process on this rank (the first reset draws, the
    params and counters after each iteration, what rank 0 wrote), the
    breakdown's window over the ranks, and the consecutive-successes counter
    of the unfused and the plain fused step under a success pattern that
    differs by rank."""
    # TensorBoard imports TensorFlow where it is installed (~13 s of this
    # rank's start on the CPU); without it the writer uses its own stub
    sys.modules["tensorflow"] = None
    inp = torch.load(os.path.join(path, "in.pt"))
    rank = int(os.environ["RANK"])
    os.environ["DEXHAND_RUNS_DIR"] = os.path.join(path, f"runs{rank}")
    os.makedirs(os.environ["DEXHAND_RUNS_DIR"])
    s = cli.build(load_config(inp["argv"]))
    try:
        env, learner, group = s.env, s.learner, s.group
        out = {"draws": [], "params": [], "state": []}
        draw = env.draw_samples

        def recording_draw(n, difficulty):
            samples = draw(n, difficulty)
            out["draws"].append(samples)
            return samples

        env.draw_samples = recording_draw
        iterate = learner.train_iteration

        def recording_iteration(ppo, env_state, obs):
            res = iterate(ppo, env_state, obs)
            out["params"].append({k: v.clone() for k, v in res[0].params.items()})
            out["state"].append((int(res[1].consecutive_successes), float(res[1].difficulty)))
            return res

        learner.train_iteration = recording_iteration
        out["rc"] = cli.run_train(s)
        out["draws"] = out["draws"][:1]
        out["stats"] = s.stats
        out["num_envs"] = env.num_envs
        out["run_dir"] = s.run_dir

        # the breakdown's window: every rank gets the sum of all ranks'
        bd = DeviceBreakdown.create(inp["window"][rank], comp_names=("a", "b"), group=group)
        bd.update(inp["window"][rank])
        out["window"] = bd.fetch_and_reset()
        out["consecutive"] = _consecutive(inp, group)
        _save(path, rank, out)
    finally:
        s.group.close()


def _consecutive(inp, group):
    """The counter after each of the pattern's steps, on the unfused step
    and on the plain fused step: `pattern[t][r]` puts a success into env 0
    of rank r at step t (the termination's own successes are cleared)."""
    env = make_sharded_env(load_config(inp["small_env"]), group, seed=1)
    evaluate, step = term_mod.evaluate_termination, [0]

    def patterned(*a, **k):
        done, info, *rest = evaluate(*a, **k)
        succ = torch.zeros_like(info["success"])
        succ[0] = bool(inp["pattern"][step[0]][group.rank])
        step[0] += 1
        return (done | succ, {**info, "success": succ, "success_rate": succ.float().mean()},
                *rest)

    term_mod.evaluate_termination = patterned
    try:
        counts, scalars = {"unfused": [], "fused": []}, []
        state, _ = env.reset_fn()
        acts = torch.zeros(env.num_envs, env.num_actions)
        for _ in inp["pattern"]:
            state, _, _, _, extras = env.step_fn(state, acts)
            counts["unfused"].append(int(state.consecutive_successes))
            scalars.append({k: float(v) for k, v in extras.items()
                            if torch.is_tensor(v) and v.ndim == 0})
        step[0] = 0
        fused = env.make_fused()
        fs, _ = fused.reset()
        for _ in inp["pattern"]:
            fs, *_ = fused.step_fn(fs, acts)
            counts["fused"].append(int(fs.consecutive_successes))
    finally:
        term_mod.evaluate_termination = evaluate
    return {**counts, "scalars": scalars}


def same_state(a, b) -> bool:
    """Whether two PPO states (or two env states) hold equal tensors."""
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


def _flat(x, prefix=""):
    if torch.is_tensor(x):
        return {prefix: x}
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    return {}

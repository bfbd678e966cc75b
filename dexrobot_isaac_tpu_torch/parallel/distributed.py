"""Multi-GPU training: each rank steps its shard of the envs, the learner
all-reduces.

The port's counterpart of `dexrobot_isaac_tpu/parallel/distributed.py`
(`make_sharded_reset`, `make_sharded_train_step`) and of
`__graft_entry__.dryrun_multichip`. JAX runs the env step and the PPO
update per shard inside `shard_map` over the `data` mesh axis; here each
shard is a process (`init_distributed`, parallel/mesh.py) that builds only
its own `numEnvs / world_size` envs, steps them with the same fused step
(K1 on the card, on the rank's local batch) that a single process uses,
and trains a learner whose collectives sit where the JAX learner's
`pmean`/`psum` do (rl/ppo.py). The global env batch is the ranks' shards
in rank order. The per-rank train step (JAX `make_sharded_train_step`) is
the learner's own `train_iteration`, or `make_chunked_train_step(chunk)`
for `chunk` iterations per call: a learner built with the rank's `group`
carries the collectives. Evaluation stays single-process, as in JAX.

    python -m dexrobot_isaac_tpu_torch.parallel.distributed [N]

runs `dryrun_multichip(N)` (default 4): N gloo processes on the CPU train
one small sharded iteration and rank 0 prints one OK line.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.multiprocessing as mp

from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.parallel.mesh import Group, free_port, init_distributed


def make_sharded_env(cfg: Dict[str, Any], group: Group, seed: Optional[int] = None):
    """This rank's env: its shard of `numEnvs` on its device, drawing from
    its own generator (JAX `make_sharded_reset`: each shard builds only its
    local slice). Its `reset_fn` (or the fused step's `reset`) resets it."""
    return make_env(cfg, seed=seed, device=group.device, group=group)


def spawn_ranks(fn: Callable, nprocs: int, args: Tuple = (), timeout: float = 120.0) -> None:
    """Run `fn(*args)` in `nprocs` new processes joined as one gloo group on
    localhost (torchrun's environment, set per rank). Raises if a rank
    raises or the ranks outlast `timeout` seconds (then they are killed)."""
    ctx = mp.start_processes(_rank_entry, args=(fn, nprocs, free_port(), args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{nprocs} ranks of {fn.__qualname__} outlasted {timeout} s")


def _rank_entry(rank: int, fn: Callable, nprocs: int, port: int, args: Tuple) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    fn(*args)


def dryrun_multichip(n: int, timeout: float = 120.0) -> None:
    """One full sharded training iteration (rollout of the fused step, GAE,
    minibatch updates with the gradient all-reduce) of a small BlindGrasping
    config over `n` gloo ranks on the CPU, 4 envs each; rank 0 prints one
    OK line. Raises if a rank fails, the KL is not finite or the ranks'
    parameters differ."""
    spawn_ranks(_dryrun_rank, n, (n,), timeout)


def _dryrun_rank(n: int) -> None:
    from dexrobot_isaac_tpu_torch.rl.ppo import PPOConfig, PPOLearner
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    group = init_distributed("cpu")
    try:
        num_envs = 4 * n
        env = make_sharded_env(load_config([
            "task=BlindGrasping", f"numEnvs={num_envs}", "sim.substeps=2",
            "env.episodeLength=20"]), group, seed=0)
        # the fused step's plain version: the CPU has no kernel to launch
        fused = env.make_fused()
        cfg = PPOConfig(num_actions=env.num_actions, num_obs=env.num_obs,
                        num_states=env.num_states, num_envs=num_envs, horizon_length=4,
                        minibatch_size=2 * n, mini_epochs=2, units=(64, 64))
        learner = PPOLearner(cfg, fused.step_fn, seed=0, device="cpu", group=group)
        learner.comp_names = fused.comp_names
        ppo = learner.broadcast_state(learner.init_state())
        fs, obs = fused.reset()
        ppo, fs, obs, metrics, _ = learner.train_iteration(ppo, fs, obs)
        kl, reward = float(metrics["kl"]), float(metrics["reward_mean"])
        if not math.isfinite(kl):
            raise RuntimeError(f"rank {group.rank}: the sharded training step gave KL {kl}")
        flat = torch.cat([v.reshape(-1) for v in ppo.params.values()])
        ref = flat.clone()
        group.broadcast_([ref])
        spread = float(group.all_reduce_max((flat - ref).abs().max()))
        if spread != 0.0:
            raise RuntimeError(f"the ranks' parameters differ by {spread} after the iteration")
        if group.is_main:
            print(f"dryrun_multichip({n}): OK — reward_mean={reward:+.4f} kl={kl:.5f} "
                  f"envs={num_envs} sharded over {n} ranks (fused env-step, plain version "
                  f"on the CPU, backend={group.backend})", flush=True)
    finally:
        group.close()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)

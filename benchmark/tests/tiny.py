"""A cell's spec shrunk for the CPU tests: a few envs, one substep per
physics step and short episodes, with the same loops, reference and
limits."""

from __future__ import annotations

import copy

from benchmark import run

TINY = ["numEnvs=8", "sim.substeps=1", "env.episodeLength=12"]


def spec(workload: str):
    s = copy.deepcopy(run.cell_spec(workload))
    s.config["overrides"] = [*s.config["overrides"], *TINY]
    s.config["num_envs"] = 8
    t = s.traffic
    if t["loop"] == "step":
        t.update(warmup_steps=2, check_within=8, checked_random=2, profiled_steps=3)
    else:
        t.update(chunk=3, checked_steps=2, profiled_iterations=1)
        t["overrides"] = ["train.params.config.horizon_length=4", "train.params.config.mini_epochs=2",
                          "train.params.config.minibatch_size=16"]
    return s


def run_tiny(workload: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
             control: bool = False, fault=None):
    return run.run_cell(workload, seed, seconds, trace, "cpu", spec(workload), control=control,
                        fault=fault)

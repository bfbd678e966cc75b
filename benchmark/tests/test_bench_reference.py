"""The frozen reference against the port's plain versions at a small size
on the CPU, and what the benchmark's modules import."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

JAX_SIDE = {"jax", "jaxlib", "flax", "dexrobot_isaac_tpu"}
PORT = "dexrobot_isaac_tpu_torch"


@pytest.mark.parametrize("config", ["blind_grasping_curriculum", "box_stacking"])
def test_reference_step_is_the_ports_plain_step(config):
    from benchmark.reference.plain.factory import make_env as ref_make_env
    from benchmark.reference.plain.utils.config import load_config as ref_load
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    ov = [*run.load_json(run.HERE, "configs", config + ".json")["overrides"], *tiny.TINY]
    renv = ref_make_env(ref_load(ov), seed=3, device="cpu")
    penv = make_env(load_config(ov), seed=3, device="cpu")
    rs, ro = renv.reset_fn()
    ps, po = penv.reset_fn()
    assert torch.equal(ro, po)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        a = torch.rand(8, penv.num_actions, generator=gen) * 2 - 1
        rs, ro, rr, rd, _ = renv.step_fn(rs, a)
        ps, po, pr, pd, _ = penv.step_fn(ps, a)
        assert torch.equal(ro, po) and torch.equal(rr, pr) and torch.equal(rd, pd)


def test_reference_learner_follows_the_ports_learner():
    line = tiny.run_tiny("blind_grasping_curriculum.train", seed=11)
    c = {k: v["value"] for k, v in line["checks"].items()}
    for k in ("obs_gap", "rew_gap", "done_mismatch", "state_gap", "reset_gap"):
        assert c[k] == 0.0, k        # the same plain step on the CPU
    for k in ("loss_gap", "grad1_gap", "delta3_gap", "action_gap"):
        assert c[k] < 1e-4, k        # f32 rounding of two implementations
    assert line["correct"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub):
    root = os.path.join(run.HERE, sub)
    for d, _, files in os.walk(root):
        if os.sep + "tests" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_the_jax_side():
    for path in _sources(""):
        bad = set(_imports(path)) & JAX_SIDE
        assert not bad, (path, bad)     # whole top-level names: the port's is allowed


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        bad = set(_imports(path)) & (JAX_SIDE | {PORT})
        assert not bad, (path, bad)
    code = ("import sys, benchmark.reference.judge, benchmark.reference.ppo, "
            "benchmark.reference.plain.factory; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & (JAX_SIDE | {PORT})


def test_a_run_loads_nothing_of_the_jax_side():
    tiny.run_tiny("box_stacking.step", seconds=0.2)
    assert run.forbidden_modules() == []

"""Rules of the torch port (`dexrobot_isaac_tpu_torch`), checked on the CPU.

- importing every module of the port, its `tools` subpackage included,
  loads neither jax (nor flax, optax, msgpack) nor the JAX package: the
  port reads the JAX package's `.ckpt` files with its own msgpack reader;
- `make_env`, `HandPhysics` (also with Coriolis terms), the `convert`
  helpers and the CLI run on CUDA unless asked for the CPU, and raise
  without CUDA;
- the fused step refuses the Coriolis configuration;
- the tools (`diag_rollout`, `dexhand_test`) and the export CLI run on CUDA
  unless asked for the CPU;
- the port's samplers stay inside the configured ranges (a distribution
  check: torch and jax.random cannot give the same bits);
- the golden-replay operand fixture (`dexrobot_isaac_tpu_torch/data/
  golden_operands.npz`) equals what the JAX package produces now.

Regenerate the fixture with `python tests/test_torch_port_rules.py`.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import golden_scenario as gs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "dexrobot_isaac_tpu_torch", "data", "golden_operands.npz")


def make_golden_operands():
    """The golden scenario's reset and DR operands as the JAX fused step
    draws them (tests/golden_scenario.py: seed 123, 8 envs, 12 steps), plus
    the initial reset sample and the actions. Reset values are unprojected:
    the port projects them, as the kernel does."""
    from dexrobot_isaac_tpu.factory import make_env
    from dexrobot_isaac_tpu.utils.config import load_config

    env = make_env(load_config(list(gs.CONFIG)), seed=gs.SEED)
    task, n = env.comps.task, env.num_envs
    rng = np.random.default_rng(gs.SEED)
    actions = rng.uniform(-1.0, 1.0, (gs.STEPS, n, env.num_actions)).astype(np.float32)
    difficulty = jnp.asarray(env.comps.initial_difficulty, jnp.float32)

    @jax.jit
    def rows(k):
        r = task.reset_task(k, n, env._default_dof, difficulty=difficulty, project=False)
        parts = [r.dof_pos, r.box_pos, r.box_quat] + [
            r.task_states[key].reshape(n, -1).astype(jnp.float32)
            for key in sorted(r.task_states)]
        return jnp.concatenate(parts, axis=1).T

    key, task_key, _ = jax.random.split(jax.random.key(gs.SEED), 3)
    init = rows(task_key)
    rst = []
    for _ in range(gs.STEPS):
        key, reset_key, _ = jax.random.split(key, 3)
        rst.append(rows(reset_key))
    assert not env.comps.dr_ranges, "the golden scenario has no DR: DR rows are ones"
    return {
        "init_rst": np.asarray(init),
        "rst": np.stack([np.asarray(r) for r in rst]),
        "drn": np.ones((gs.STEPS, 4, n), np.float32),
        "actions": actions,
    }


def test_golden_operand_fixture_is_current():
    want = make_golden_operands()
    got = dict(np.load(FIXTURE))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dexrobot_isaac_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'dexrobot_isaac_tpu'))\n"
        "assert not bad, bad\n"
        "assert {'dexrobot_isaac_tpu_torch.tools.diag_rollout', "
        "'dexrobot_isaac_tpu_torch.tools.dexhand_test', 'dexrobot_isaac_tpu_torch.rl.export', "
        "'dexrobot_isaac_tpu_torch.models.mjcf', 'dexrobot_isaac_tpu_torch.envs.rule_based', "
        "'dexrobot_isaac_tpu_torch.parallel.mesh', 'dexrobot_isaac_tpu_torch.parallel.distributed'} "
        "<= set(sys.modules)\n"
        "print(len([k for k in sys.modules if k.startswith('dexrobot_isaac_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_make_env_requires_cuda_unless_cpu(monkeypatch):
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    cfg = load_config(["task=BlindGrasping", "numEnvs=2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_env(cfg)
    env = make_env(cfg, device="cpu")
    assert env.device.type == "cpu"


def test_engine_and_convert_require_cuda_unless_cpu(monkeypatch):
    from dexrobot_isaac_tpu_torch import convert
    from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HandPhysics()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.tensor(np.zeros(3, np.float32))
    assert HandPhysics(device="cpu").device.type == "cpu"
    assert convert.tensor(np.zeros(3, np.float32), "cpu").device.type == "cpu"


def test_coriolis_engine_and_cli_require_cuda_unless_cpu(monkeypatch, tmp_path):
    from dexrobot_isaac_tpu_torch import train as cli
    from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics
    from dexrobot_isaac_tpu_torch.physics.types import SimParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DEXHAND_RUNS_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HandPhysics(params=SimParams(coriolis=True))
    assert HandPhysics(params=SimParams(coriolis=True), device="cpu").params.coriolis
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["task=BlindGrasping", "numEnvs=2", "maxIterations=1"])
    assert not os.path.exists(os.path.join(str(tmp_path), "runs_all"))  # refused first


def test_tools_require_cuda_unless_cpu(monkeypatch):
    from dexrobot_isaac_tpu_torch.tools import dexhand_test, diag_rollout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dexhand_test.main(["task=BaseTask"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag_rollout.run("any.ckpt", "BaseTask")


def test_fused_step_refuses_coriolis():
    from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    env = make_env(load_config(["task=BlindGrasping", "numEnvs=2", "sim.coriolis=true"]),
                   device="cpu")
    with pytest.raises(FusedUnsupported, match="coriolis"):
        env.make_fused()


def test_samplers_stay_in_configured_ranges():
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.physics.types import DRSample
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    env = make_env(load_config(["task=BlindGrasping", "numEnvs=4"]), seed=0, device="cpu")
    t, n = env.comps.task, 4096
    r = t.reset_task(env.generator, n, env._default_dof, difficulty=torch.tensor(1.0),
                     project=False)
    dof = r.dof_pos.numpy()
    assert np.abs(dof[:, :3]).max() <= t.hand_translation_range
    assert np.abs(dof[:, 3:6]).max() <= t.hand_rotation_range
    assert 0 <= dof[:, 6].min() and dof[:, 6].max() <= t.thumb_rotation_range
    assert 0 <= dof[:, 7:].min() and dof[:, 7:].max() <= t.other_finger_range
    bp = r.box_pos.numpy()
    assert np.abs(bp[:, :2]).max() <= t.box_xy_range and np.all(bp[:, 2] == np.float32(t.box_z))
    np.testing.assert_allclose(np.linalg.norm(r.box_quat.numpy(), axis=1), 1.0, atol=1e-6)
    # uniform: mean and spread of each coordinate near the continuous ones
    u = dof[:, 0] / t.hand_translation_range
    assert abs(u.mean()) < 0.05 and abs(u.std() - 1 / math.sqrt(3)) < 0.03
    yaw = 2 * np.arctan2(r.box_quat[:, 2].numpy(), r.box_quat[:, 3].numpy())
    assert abs(yaw.mean()) < 0.15 and abs(yaw.std() - math.pi / math.sqrt(3)) < 0.1
    # spawn projection lifts only what needs lifting, to the clearance
    proj = t.project_spawn(r.dof_pos)
    lift = (proj - r.dof_pos).numpy()
    assert np.all(lift[:, [0, 1] + list(range(3, 26))] == 0) and np.all(lift[:, 2] >= 0)
    mz = t._min_tip_z_fn(proj).numpy()
    assert np.all(mz >= t.spawn_projection_clearance - 1e-5)
    dr = DRSample.sample(env.generator, n, {"kp_scale": (0.8, 1.2), "friction_scale": (0.5, 1.5)})
    assert 0.8 <= dr.kp_scale.min() and dr.kp_scale.max() <= 1.2
    assert 0.5 <= dr.friction_scale.min() and dr.friction_scale.max() <= 1.5
    assert torch.all(dr.kd_scale == 1.0) and torch.all(dr.box_mass_scale == 1.0)
    assert abs(float(dr.kp_scale.mean()) - 1.0) < 0.01


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez_compressed(FIXTURE, **make_golden_operands())
    print("wrote", FIXTURE)

"""The port's measurement tools on the CPU, held to the JAX repo's tools where
they compute the same thing (`dexrobot_isaac_tpu_torch/bench.py` and
`dexrobot_isaac_tpu_torch/tools/`: count_flops, roofline, the update and
training anatomies, bench_kernel, measure_coriolis, record_golden and the
two MJCF generators).

The JAX side (`tests/torch_measure_jax.py`) runs in subprocesses started
with the module and read at its end: XLA's cost of the JAX step at 1
substep x 1 physics step, and `tools/measure_coriolis.py`'s sweep at each
velocity scale.

FLOP counts: the port counts every op the plain step executes, so each
substep counts. The JAX `tools/count_flops.py` counts a loop body once: at
4 substeps x 4 physics steps it gives 135,184 FLOPs per env step and
134,920 at 1 substep x 4 physics steps, though the first runs 16 substeps
and the second 4; its count is no reference there. Its compiled count at
1 x 1 (140,643) is no reference either: XLA's CPU compiler duplicates cheap
producers into each consumer fusion, and its cost analysis counts the
copies (the JAX FK alone: 47,754 FLOPs per env compiled against 3,899 in
the lowered program). So the 1 x 1 count is held to the same
`HloCostAnalysis` of the lowered JAX program (66,832 per env step), where
the loop runs once and no fusion has duplicated anything: both count the
same dense algorithm, decomposed into different ops.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch import bench
from dexrobot_isaac_tpu_torch.envs import fused_step as fsm
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.physics import lane_step
from dexrobot_isaac_tpu_torch.tools import (
    bench_kernel,
    bench_train_anatomy,
    bench_update_anatomy,
    count_flops,
    gen_dexhand_mjcf,
    gen_upstream_fixture,
    measure_coriolis,
    record_golden,
    roofline,
)
from dexrobot_isaac_tpu_torch.utils.config import load_config
from dexrobot_isaac_tpu_torch.utils.kernel_build import CSRC
from tests import golden_scenario as gs
from tests.proc import run, start, stop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_SUBSTEP = ("sim.substeps=1", "sim.physics_steps_per_control=1")
# seconds for a JAX subprocess's result: each takes 17-66 s alone on 8 CPU
# cores, and the three run beside the tier-1 command's six workers
JAX_SIDE_TIMEOUT = 400
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "median_of_5", "flops_per_env_step",
             "achieved_flops_per_s", "mfu", "f32_mfu")


@pytest.fixture(scope="module")
def jax_side():
    """The JAX numbers, computed in subprocesses beside this module's tests:
    jax_side(part) -> the part's result, "count" or "coriolis <scale>"."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    parts = ["count"] + [f"coriolis {scale}" for scale, _ in measure_coriolis.SCALES]
    procs = {part: start([sys.executable, "-m", "tests.torch_measure_jax", *part.split()],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True) for part in parts}
    done = {}

    def result(part):
        if part not in done:
            out, err = procs[part].communicate(timeout=JAX_SIDE_TIMEOUT)
            assert procs[part].returncode == 0, err[-3000:]
            done[part] = json.loads(out.strip().splitlines()[-1])
        return done[part]

    try:
        yield result
    finally:
        stop(procs.values())


@pytest.fixture(scope="module", autouse=True)
def _start_jax_side(jax_side):
    """Starts the JAX subprocess with the module's first test, and runs the
    module's torch ops on one thread: at these sizes the ops are too small
    to share out, and under the suite's parallel workers a thread pool per
    process oversubscribes the cores (the update anatomy took 30x longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- bench
def test_bench_prints_one_line_with_both_paths(capsys):
    bench.run(8, 16, "cpu", overrides=ONE_SUBSTEP)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == LINE_KEYS
    assert line["metric"].startswith("env-steps/s/chip (BlindGrasping, 8 envs, ")
    assert line["value"] > 0 and line["median_of_5"] > 0 and line["unit"] == "env-steps/s"
    assert line["flops_per_env_step"] == pytest.approx(
        count_flops.count("BlindGrasping", 8, ONE_SUBSTEP)["flops_per_env_step"], abs=0.1)
    paths = next(ln for ln in err.splitlines() if ln.startswith("paths"))
    assert " fused=" in paths and " unfused=" in paths and "the host's CPU" in paths
    assert any(ln.startswith("launches") for ln in err.splitlines())


def test_bench_path_restricts_to_fused(capsys, monkeypatch):
    monkeypatch.setenv("DEXHAND_BENCH_PATH", "fused")
    res = bench.run(8, 16, "cpu", overrides=ONE_SUBSTEP)
    out, err = capsys.readouterr()
    assert list(res["per_path"]) == ["fused"]
    assert json.loads(out)["metric"].endswith(", fused)")
    assert "unfused=" not in err


def test_bench_refuses_an_unknown_path(monkeypatch):
    monkeypatch.setenv("DEXHAND_BENCH_PATH", "xla")
    with pytest.raises(ValueError, match="DEXHAND_BENCH_PATH"):
        bench.run(8, 16, "cpu")


# ---------------------------------------------------------------- count_flops
def test_count_is_linear_in_substeps():
    c = {s: count_flops.count("BlindGrasping", 8, (f"sim.substeps={s}",))["flops_per_env_step"]
         for s in (1, 2, 4)}
    per_substep = c[2] - c[1]
    assert per_substep > 0
    assert abs(c[4] - (c[2] + 2 * per_substep)) <= 0.01 * c[4], c


def test_count_scales_with_envs():
    c8 = count_flops.count("BlindGrasping", 8, ONE_SUBSTEP)["flops_per_env_step"]
    c16 = count_flops.count("BlindGrasping", 16, ONE_SUBSTEP)["flops_per_env_step"]
    assert abs(c16 - c8) <= 1e-3 * c8, (c8, c16)


def test_count_cli_prints_the_jax_keys(capsys):
    assert count_flops.main(["BlindGrasping", "8", *ONE_SUBSTEP]) == 0
    line = json.loads(capsys.readouterr().out)
    assert tuple(line) == ("task", "num_envs", "flops_per_step", "flops_per_env_step")
    assert line["flops_per_step"] == 8 * line["flops_per_env_step"]


# ---------------------------------------------------------------- roofline
@pytest.fixture(scope="module")
def host_fused_lib(tmp_path_factory):
    """K1's BlindGrasping build compiled for the host by g++, as
    tests/test_torch_kernel_source.py builds it (the roofline reads its own
    unoptimized build, `kernel_build.host_library`)."""
    out = str(tmp_path_factory.mktemp("roofline_host") / "fused_step.so")
    run(["g++", "-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", out,
         os.path.join(CSRC, "fused_step.cu")], timeout=300)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def roof():
    return roofline.run(8, 1000.0, "cpu")


def test_roofline_bytes_are_the_fused_steps_operands_and_outputs(roof):
    env = make_env(load_config(["task=BlindGrasping", "numEnvs=8"]), seed=0, device="cpu")
    fused = env.make_fused()
    fs, _ = fused.reset()
    n = 8
    reset, dr = env.draw_samples(n, fs.difficulty)
    rst, drn = fused.operand_rows(reset, dr, n, "cpu")
    act = torch.zeros(env.num_actions, n)
    spw = env._spawn[:, None].expand(3, n).contiguous()
    outs = fused.kernel(fs.rows_f, fs.rows_i, act, rst, drn, spw)
    ins = (fs.rows_f, fs.rows_i, act, rst, drn, spw)
    want = roofline.nbytes(*ins, *outs, fs.rows_f, fs.rows_i)
    assert roof["bytes_per_env_step"] * n == want
    assert roof["bytes_in_per_env_step"] * n == roofline.nbytes(*ins)


def test_roofline_k1_count_is_fused_step_flops(roof, host_fused_lib):
    env = make_env(load_config(["task=BlindGrasping", "numEnvs=8"]), seed=0, device="cpu")
    fused = fsm.build_fused_step(env, lib=host_fused_lib)
    c = env.comps
    cfg = fsm.fused_config_array(env, fused.layout, fused.comp_names, fused.rst_rows,
                                 host_fused_lib)
    model = lane_step.lane_model_array(c.engine, c.physics_steps_per_control, host_fused_lib)
    assert roof["k1_flops_per_env_step"] * 8 == fsm.fused_step_flops(cfg, model, 8, 0)
    assert roof["flops_per_env_step"] == count_flops.count()["flops_per_env_step"]
    assert roof["f32_share"] == pytest.approx(
        roof["flops_per_env_step"] * 1000.0 / roofline.H100_F32_PER_S)


def test_bound_is_the_larger_time():
    assert roofline.bound(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    assert roofline.bound(0, 67e9) == pytest.approx((1.0, "operations"))
    assert roofline.nbytes(torch.zeros(3, 2), torch.zeros(4, dtype=torch.int64)) == 56


# ---------------------------------------------------------------- anatomies
def test_update_anatomy_prints_every_config(capsys):
    res = bench_update_anatomy.run(64, "cpu", reps=1)
    out = capsys.readouterr().out
    for tag, _ in bench_update_anatomy.CONFIGS:
        assert f"{tag:42s}:" in out
        ms, kl = res["configs"][tag]
        assert ms > 0 and np.isfinite(kl), (tag, ms, kl)
    parts = res["split"]
    assert all(parts[p] > 0 for p, _ in bench_update_anatomy.PARTS)
    assert sum(parts[p] for p, _ in bench_update_anatomy.PARTS) <= parts["iteration"]
    assert "parts sum" in out


def test_update_anatomy_env_is_jaxs():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    state = rng.standard_normal((64, 130)).astype(np.float32)
    actions = rng.uniform(-1, 1, (64, 18)).astype(np.float32)
    # tools/bench_update_anatomy.py env_step
    want = state * 0.999 + 0.001 * jnp.sum(jnp.asarray(actions), axis=-1, keepdims=True)
    obs, obs2, rew, done, extras = bench_update_anatomy.synthetic_step(
        torch.as_tensor(state), torch.as_tensor(actions))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rew.numpy(), np.asarray(want)[:, 0])
    assert obs2 is obs and not done.any() and not extras["timeout"].any()


def test_train_anatomy_prints_each_line(capsys):
    res = bench_train_anatomy.run(
        8, ("permutation", "affine"), (1, 2), "cpu", reps=1, chunk_reps=1,
        overrides=(*ONE_SUBSTEP, "train.params.config.horizon_length=2",
                   "train.params.network.units=[32,32]"))
    out = capsys.readouterr().out
    for label in ("env-only", "rollout (act+step)", "train_iteration", "chunked x1 [permutation]",
                  "chunked x2 [permutation]", "chunked x1 [affine]", "chunked x2 [affine]"):
        assert label in out
    assert len(res) == 7 and all(v > 0 for v in res.values())


def test_bench_kernel_prints_json_lines(capsys):
    lines = bench_kernel.run((8,), 2, "cpu")
    got = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert got == lines and len(got) == 1
    assert got[0]["substeps_per_call"] == 8 and got[0]["value"] > 0
    assert got[0]["metric"] == "kernel env-steps/s (8 envs, the plain engine)"


# ---------------------------------------------------------------- record_golden
def test_record_golden_scenario_is_the_tests():
    assert record_golden.CONFIG == gs.CONFIG
    assert (record_golden.SEED, record_golden.STEPS) == (gs.SEED, gs.STEPS)
    assert os.path.samefile(record_golden.TPU_GOLDEN, os.path.join(REPO, "tests", gs.GOLDEN))


def test_record_golden_writes_the_goldens_layout(tmp_path):
    path = str(tmp_path / "rec.npz")
    record_golden.write(path, "cpu")
    rec, golden = dict(np.load(path)), dict(np.load(record_golden.TPU_GOLDEN))
    assert sorted(rec) == sorted(golden)
    for k in golden:
        assert rec[k].shape == golden[k].shape and rec[k].dtype == golden[k].dtype, k
    err = record_golden.golden_errors(rec)
    assert err["done"]
    assert all(err[k] <= b for k, b in record_golden.BUDGETS.items()), err


def test_record_golden_refuses_the_tpu_golden():
    with open(record_golden.TPU_GOLDEN, "rb") as f:
        before = f.read()
    with pytest.raises(ValueError, match="refusing"):
        record_golden.write(os.path.join(REPO, "tests", "golden", "fused_blind_grasping.npz"),
                            "cpu")
    with open(record_golden.TPU_GOLDEN, "rb") as f:
        assert f.read() == before


# ---------------------------------------------------------------- generators
@pytest.mark.parametrize("tool, committed", [
    (gen_dexhand_mjcf, "dexrobot_isaac_tpu/assets/dexhand021_right_simplified_floating.xml"),
    (gen_upstream_fixture, "tests/fixtures/dexhand021_upstream_format.xml"),
])
def test_generator_output_is_the_committed_file(tmp_path, tool, committed):
    out = str(tmp_path / "out.xml")
    assert tool.main([out]) == 0
    with open(out, "rb") as a, open(os.path.join(REPO, committed), "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------- the device rule
@pytest.mark.parametrize("call", [
    lambda: bench.run(8, 16),
    lambda: roofline.run(8, 1.0),
    lambda: bench_update_anatomy.run(8),
    lambda: bench_train_anatomy.run(8),
    lambda: bench_kernel.run((8,)),
    lambda: measure_coriolis.run(0.1),
    lambda: record_golden.record(),
], ids=["bench", "roofline", "update_anatomy", "train_anatomy", "bench_kernel",
        "measure_coriolis", "record_golden"])
def test_tools_require_cuda_unless_cpu(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


# ---------------------------------------------------------------- against the JAX side
# last in the module, so the port's tests above run while the JAX subprocess
# computes
def test_count_matches_jax_at_one_substep(jax_side):
    port = count_flops.count("BlindGrasping", 8, ONE_SUBSTEP)["flops_per_env_step"]
    want = jax_side("count")
    assert abs(port - want) <= 0.25 * want, (port, want)


def test_measure_coriolis_matches_jaxs_tool(jax_side, capsys):
    got = measure_coriolis.run(0.2, "cpu")
    assert "[3x stress]" in capsys.readouterr().out
    for scale, label in measure_coriolis.SCALES:
        g, w = got[label], jax_side(f"coriolis {scale}")
        for key, rtol in (("dqd_max", 1e-3), ("bias_max", 1e-3), ("dq_max", 1e-2)):
            assert abs(g[key] - w[key]) <= rtol * abs(w[key]), (label, key, g[key], w[key])

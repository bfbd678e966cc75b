"""The tier-1 harness of the repo-root `conftest.py`: XLA:CPU's legacy
emitters in every test process, the heavy JAX tests' units of work under
`--dist loadfile`, and the time limit on each test's call."""

import os
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import jax
import pytest

from tests.proc import run

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def harness(pytestconfig):
    """The repo-root `conftest.py` as pytest loaded it."""
    module = pytestconfig.pluginmanager.get_plugin(str(ROOT / "conftest.py"))
    assert module is not None, "pytest did not load the repo-root conftest.py"
    return module


def test_legacy_emitters_in_this_process(harness):
    assert os.environ["XLA_FLAGS"].split().count(harness.LEGACY_EMITTERS) == 1
    devices = jax.devices()
    assert [d.platform for d in devices] == ["cpu"] * 8


@pytest.mark.parametrize(
    "nodeid, unit",
    [
        ("tests/test_fused_step.py::TestHybridParity::test_base_task", None),
        ("tests/test_golden_trajectory.py::TestGoldenTrajectory::test_xla_reference_matches_tpu_golden", None),
        ("tests/test_physics.py::TestGrasp::x", "tests/test_physics.py::TestGrasp"),
        ("tests/test_physics.py::TestFK::test_fk[1-2]", "tests/test_physics.py::TestFK"),
        ("tests/test_fused_step.py::TestSupportChecks::test_task_without_lane_step_is_refused", "tests/test_fused_step.py"),
        ("tests/test_torch_ppo.py::test_clip_and_adam_match_optax", "tests/test_torch_ppo.py"),
    ],
)
def test_work_unit(harness, nodeid, unit):
    assert harness.work_unit(nodeid) == (unit or nodeid)


def make_scheduler(harness, dist):
    class Config:
        def getvalue(self, name):
            return {"dist": dist, "tx": ["2*popen"]}[name]

    return harness.pytest_xdist_make_scheduler(Config(), log=None)


@pytest.mark.parametrize("dist", ["loadfile", "load", "loadscope", "no"])
def test_scheduler_only_under_loadfile(harness, dist):
    from xdist.scheduler import LoadScopeScheduling

    scheduler = make_scheduler(harness, dist)
    if dist != "loadfile":
        assert scheduler is None
        return
    assert isinstance(scheduler, LoadScopeScheduling)
    hybrid = "tests/test_fused_step.py::TestHybridParity::test_base_task"
    assert scheduler._split_scope(hybrid) == hybrid


def test_time_limit_fails_a_long_call(harness, tmp_path):
    source = (ROOT / "conftest.py").read_text()
    limit = f"CALL_LIMIT_S = {harness.CALL_LIMIT_S}\n"
    assert source.count(limit) == 1
    (tmp_path / "conftest.py").write_text(source.replace(limit, "CALL_LIMIT_S = 2\n"))
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "test_sleep.py").write_text(
        "import time\n\n\n"
        "def test_past_the_limit():\n    time.sleep(10)\n\n\n"
        "def test_within_the_limit():\n    time.sleep(0.1)\n"
    )
    junit = tmp_path / "junit.xml"
    # pytest starts in about 1 s here and its two tests take about 2.1 s.
    with pytest.raises(RuntimeError, match="exited 1") as failed:
        run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", f"--junitxml={junit}", "test_sleep.py"],
            timeout=120,
            cwd=tmp_path,
        )
    assert "test_sleep.py::test_past_the_limit ran past its time limit of 2 s" in str(failed.value)
    cases = {case.get("name"): case for case in ET.parse(junit).iter("testcase")}
    past, within = cases["test_past_the_limit"], cases["test_within_the_limit"]
    assert past.find("failure") is not None
    assert float(past.get("time")) < 10
    assert list(within) == []

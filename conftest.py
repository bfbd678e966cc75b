"""The tier-1 test harness, loaded before `tests/conftest.py`.

pytest loads this file from the rootdir (the repo root, which holds the
pytest settings in `pyproject.toml`) in the xdist controller and in every
worker. It holds three things:

- XLA:CPU's legacy emitters for the JAX reference's programs;
- under `--dist loadfile`, the heavy JAX tests in units of work of their own;
- a time limit on each test's call.

The times below were measured with the tier-1 command (`pytest tests/ -q
-m 'not slow' -p xdist -n 6 --dist loadfile`) on 8 CPU cores, cold.
"""

import os
import signal
import threading

import pytest

# XLA:CPU's fusion emitters take several times longer than the legacy ones to
# compile the JAX reference's step programs: `TestHybridParity::test_base_task`
# took 480 s under them and 84 s under these, and the tier-1 command, cut at
# 1470 s before, ended in 1024 s with every test passing. Only the code
# generator changes; every parity and golden check holds its tolerance.
LEGACY_EMITTERS = "--xla_cpu_use_fusion_emitters=false"

_flags = os.environ.get("XLA_FLAGS", "")
if LEGACY_EMITTERS not in _flags.split():
    os.environ["XLA_FLAGS"] = f"{_flags} {LEGACY_EMITTERS}".strip()

# `--dist loadfile` makes each file one unit of work, run test after test on
# one worker. These tests run apart instead (times before the legacy
# emitters):
# - each case of `TestHybridParity`: the cases share no fixture, and each
#   compiles its own program (448 s and 346 s for two of them);
# - each golden replay (389 s and 283 s);
PER_TEST = (
    "tests/test_fused_step.py::TestHybridParity::",
    "tests/test_golden_trajectory.py::",
)
# - each class of the physics tests (the file took 1188 s on one worker).
PER_CLASS = ("tests/test_physics.py",)


def work_unit(nodeid: str) -> str:
    """The unit of work that the test `nodeid` runs in under `--dist
    loadfile`: the test itself, its class, or its file."""
    if nodeid.startswith(PER_TEST):
        return nodeid
    path, _, rest = nodeid.partition("::")
    if path in PER_CLASS:
        return f"{path}::{rest.split('::', 1)[0]}"
    return path


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """xdist's file scheduling, in the units of `work_unit`."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class WorkUnitScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid: str) -> str:
            return work_unit(nodeid)

    return WorkUnitScheduling(config, log)


# With the legacy emitters the longest test's call took 171-180 s under six
# workers (`test_distributed.py`'s two-process run), a `TestHybridParity` case
# at most 147 s. A hang costs this limit and one failure, not the whole run.
# Fixture setup is not limited, so module fixtures keep the time their
# compiles take.
CALL_LIMIT_S = 300


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Fail the test if its call runs longer than `CALL_LIMIT_S`. The alarm
    acts between bytecodes of the main thread, so it waits for a native call
    (an XLA compile) to return."""
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        return (yield)

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {CALL_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CALL_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)

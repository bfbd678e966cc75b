"""Subprocesses of the tests: every wait has a deadline, and a test leaves no
process of its own running, whether it passes, fails or times out.

Each process starts in a session of its own (`start`), so that `stop` kills
it together with everything it started, also once it has exited itself."""

import os
import signal
import subprocess
import time


def start(cmd, **kw) -> subprocess.Popen:
    """`subprocess.Popen(cmd, **kw)` in a new session (its own process
    group)."""
    return subprocess.Popen(cmd, start_new_session=True, **kw)


def stop(procs) -> None:
    """Kill the process group of each of `procs` and reap each process."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        for pipe in (p.stdout, p.stderr):
            if pipe is not None:
                pipe.close()


def wait_all(procs, timeout: float) -> list:
    """The (stdout, stderr) of each of `procs`, in order, all within one
    deadline `timeout` seconds away. Then, or when the deadline passes or a
    wait raises, every process group is killed (`subprocess.TimeoutExpired`
    names the process being waited on)."""
    deadline = time.monotonic() + timeout
    try:
        return [p.communicate(timeout=max(0.1, deadline - time.monotonic())) for p in procs]
    finally:
        stop(procs)


def run(cmd, timeout: float, **kw) -> str:
    """Run `cmd` to its end within `timeout` seconds and return its output
    (stdout and stderr); raise `RuntimeError` with the output's end if it
    exits nonzero."""
    p = start(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw)
    out, _ = wait_all([p], timeout)[0]
    if p.returncode:
        raise RuntimeError(f"{' '.join(map(str, cmd))} exited {p.returncode}:\n{out[-4000:]}")
    return out

"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each build of `BUILDS` (a `csrc/<source>.cu` with its compile-time
defines: the two-cube lane physics, K1's task) is compiled on first use
into `dexrobot_isaac_tpu_torch/_build/<build>-<hash>.so` (the hash covers
the sources, flags and defines, so an edited source rebuilds) with a plain
C interface:
pointers and the stream go in as `c_void_p`, and every launcher returns
`cudaGetLastError()`. `nvcc` starts one nvcc per source at once (the
probes of `utils/` build their variants with it too); `device_ms` times a
kernel's launches on the card; `card` names the card. Nothing here runs at
import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Hashable, Iterable, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
# build -> (source in csrc/, its defines); each build is its own library
BUILDS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "control_step": ("control_step", ()),                       # K2, one box
    "control_step_box2": ("control_step", ("-DLP_HAS_BOX2=1",)),  # K2, two boxes
    "fused_step": ("fused_step", ()),                           # K1, BlindGrasping
    "fused_step_base": ("fused_step", ("-DFS_TASK=0",)),          # K1, BaseTask
    "fused_step_stacking": ("fused_step", ("-DFS_TASK=2", "-DLP_HAS_BOX2=1")),  # K1, BoxStacking
    "fused_step_reorient": ("fused_step", ("-DFS_TASK=3",)),      # K1, BoxReorientation
    "fused_step_inhand": ("fused_step", ("-DFS_TASK=4",)),        # K1, InHandReorientation
    "fused_step_pushing": ("fused_step", ("-DFS_TASK=5",)),       # K1, BoxPushing
    "spd_solve": ("spd_solve", ()),                             # K3
    "clip_adam": ("clip_adam", ()),                             # the learner's clip + Adam
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}

# launches per kernel build: each wrapper adds one where it launches its
# kernel (min_site_z, in either control_step build, counts apart)
LAUNCHES: Dict[str, int] = {**{b: 0 for b in BUILDS}, "min_site_z": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(BUILDS[name][1])).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def nvcc(jobs: Dict[Hashable, tuple]) -> Dict[Hashable, Tuple[float, str]]:
    """Compile each job {key: (source, library[, defines])} with NVCC_FLAGS,
    one nvcc each, all started together. Returns {key: (seconds, nvcc's
    output)}; raises, once every nvcc has ended, if one failed."""
    procs = {}
    for key, (src, out, *defines) in jobs.items():
        cmd = [_nvcc(), *NVCC_FLAGS, *(defines[0] if defines else ()), "-o", out, src]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), time.perf_counter())
    res, failed = {}, []
    for key, (proc, t0) in procs.items():
        log, _ = proc.communicate()
        res[key] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {key} ({jobs[key][0]}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return res


def ptxas_lines(log: str) -> List[str]:
    """ptxas's register, spill and stack lines in an nvcc output."""
    return [ln.strip() for ln in log.splitlines()
            if any(s in ln for s in ("registers", "spill", "stack frame"))]


def build_all(names: Iterable[str] = BUILDS) -> Dict[str, float]:
    """Compile every build that is not built yet (`nvcc`). Returns {name:
    seconds} of the builds that ran; the ptxas report (registers, spills,
    stack) goes to `<lib>.ptxas.txt`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    res = nvcc({n: (os.path.join(CSRC, BUILDS[n][0] + ".cu"), lib_path(n) + ".tmp",
                    BUILDS[n][1]) for n in todo})
    for name, (_, log) in res.items():
        with open(lib_path(name) + ".ptxas.txt", "w") as f:
            f.write(log)
        os.replace(lib_path(name) + ".tmp", lib_path(name))
    return {name: secs for name, (secs, _) in res.items()}


def load(name: str) -> ctypes.CDLL:
    """The built library `name` (building it first if needed)."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(lib_path(name))
    return _libs[name]


def host_library(name: str) -> ctypes.CDLL:
    """The build `name` compiled for the host by g++ (the `.cu` files also
    compile as C++, their per-env code `__device__` only under nvcc), for
    the record layouts it exports where no card is: a tool's `device=cpu`
    run reads K1's records from it. Unoptimized; it launches nothing."""
    key = f"{name}-host"
    if key not in _libs:
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = lib_path(name)[:-3] + "-host.so"
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-x", "c++", "-O0", "-std=c++17", "-shared", "-fPIC",
                            *BUILDS[name][1], "-o", tmp,
                            os.path.join(CSRC, BUILDS[name][0] + ".cu")], check=True)
            os.replace(tmp, path)
        _libs[key] = ctypes.CDLL(path)
    return _libs[key]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_ms(fn, iters: int) -> float:
    """Device milliseconds per call of `fn`, whose launches go on the current
    stream: one call to warm up, then `iters` calls queued behind a kernel
    that keeps the card busy (`torch.cuda._sleep`), so that they run back to
    back on the card whatever the host's launch overhead. CUDA events time
    them; the sleep grows until the host has enqueued every call before the
    card reaches the first."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24  # ~10 ms at the H100's clock
    for _ in range(5):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        queued = not t0.query()
        torch.cuda.synchronize()
        if queued:
            return t0.elapsed_time(t1) / iters
        cycles *= 4
    raise RuntimeError("device_ms: the host did not enqueue the calls while the card slept")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

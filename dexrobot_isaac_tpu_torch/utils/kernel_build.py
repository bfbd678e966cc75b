"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` is compiled on first use into
`dexrobot_isaac_tpu_torch/_build/<name>-<hash>.so` (the hash covers the
sources and flags, so an edited source rebuilds) with a plain C interface:
pointers and the stream go in as `c_void_p`, and every launcher returns
`cudaGetLastError()`. `build_all` starts one nvcc per source at once.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("control_step", "fused_step", "spd_solve")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}

# launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES: Dict[str, int] = {"control_step": 0, "min_site_z": 0, "fused_step": 0,
                            "spd_solve": 0}


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source that is not built yet, one nvcc each, all
    started together. Returns {name: seconds} of the builds that ran; the
    ptxas report (registers, spills, stack) goes to `<lib>.ptxas.txt`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out, time.perf_counter())
    secs = {}
    for name, (proc, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        with open(out + ".ptxas.txt", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(out + ".tmp", out)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The built library `name` (building it first if needed)."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(lib_path(name))
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

"""K3: batched small-SPD solves A x = b, a CUDA kernel + its plain version.

The port of `dexrobot_isaac_tpu/ops/linalg.py`. The engine's implicit-PD
step solves `(M + h Kd + h^2 Kp) qd' = rhs`, one 26x26 SPD system per env;
the Coriolis control step (`HandPhysics.make_control_step` with
`SimParams.coriolis`) runs it through `spd_solve`:

- `spd_solve(A, b)`: on a CUDA tensor it launches `csrc/spd_solve.cu` (the
  TPU kernel's rsqrt Cholesky with the forward substitution folded in, and a
  back substitution across the lanes; one warp per system, rows in
  registers) or raises; on a CPU tensor it runs the plain version.
- `spd_solve_plain(A, b)`: `torch.linalg.cholesky` + `torch.cholesky_solve`,
  the plain engine's solve. The tests and the card's comparisons call it.

A: (N, n, n) float32, 16-byte aligned, b: (N, n) float32 -> x: (N, n). The
kernel reads only A's lower triangle.
"""

from __future__ import annotations

import ctypes

import torch

from dexrobot_isaac_tpu_torch.utils import kernel_build as kb


def spd_solve_flops(n: int) -> int:
    """f32 operations of one system in csrc/spd_solve.cu (an add, mul or
    rsqrt counts one): the factor's updates (2 per entry (i, c), j < c <= i,
    at step j: as many as the left-looking row sums, 2 j per row i >= j of
    column j), the pivots' rsqrt and the scaling of the column below each
    pivot, then both substitutions (2 per off-diagonal entry, one scaling
    per row each)."""
    factor = sum(2 * j * (n - j) + 1 + (n - 1 - j) for j in range(n))
    return factor + 2 * (n * (n - 1) + n)


def spd_solve_bytes(n: int) -> int:
    """Bytes one system in csrc/spd_solve.cu must move: A's lower triangle
    and b read once, x written once."""
    return 4 * (n * (n + 1) // 2 + 2 * n)


def spd_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _lib() -> ctypes.CDLL:
    lib = kb.load("spd_solve")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.spd_solve_launch.argtypes = [P, P, P, I, I, P]
        lib.spd_solve_dim.argtypes = []
        lib._typed = True
    return lib


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if A.device.type == "cpu":
        return spd_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {A.device}")
    lib = _lib()
    n = lib.spd_solve_dim()
    N = A.shape[0]
    for t, shape in ((A, (N, n, n)), (b, (N, n))):
        if t.device != A.device or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"spd_solve takes contiguous float32 CUDA tensors A {(N, n, n)} "
                             f"and b {(N, n)} (the kernel is built for n = {n}), got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if N < 1:
        raise ValueError("spd_solve needs at least one system")
    if A.data_ptr() % 16:
        raise ValueError("spd_solve reads A in 16-byte segments: A must be 16-byte aligned")
    x = torch.empty_like(b)
    kb.check(lib.spd_solve_launch(A.data_ptr(), b.data_ptr(), x.data_ptr(), N, n,
                                  kb.stream_ptr(A.device)), "spd_solve")
    kb.LAUNCHES["spd_solve"] += 1
    return x

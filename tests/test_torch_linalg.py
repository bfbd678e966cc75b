"""K3, the batched SPD solve, held to the TPU kernel's arithmetic (CPU).

- `spd_solve_plain` (the port's plain version) against the TPU kernel
  `dexrobot_isaac_tpu.ops.linalg._cholesky_solve_kernel` called directly on
  (n, n, B) / (n, B) arrays, which runs on the CPU as it is, and against a
  float64 solve;
- `spd_solve` on CPU tensors (the wrapper's plain route) at B = 8 and at
  B = 300 (not a multiple of the TPU's 256-env blocks);
- a g++ host build of `csrc/spd_solve.cu` (the kernel's warp phases, each a
  loop over the lanes) against the plain version, the TPU kernel's
  arithmetic and a float64 solve, on every system set: the kernel's back
  substitution sums in the other order (k descending), so it matches the
  TPU kernel to the tolerance, not to the bit. B = 1, 5 and 300 leave the
  last block of 8 systems ragged. With its lanes run forward and in reverse
  (`lane_order_host`) the host build gives the same bits.

Systems: the engine's own (one substep's `A`, `rhs` of a contact-rich
state) and seeded random SPD matrices. Tolerance 1e-5 relative (the max
error over the max magnitude of the solution).
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu.ops.linalg import _cholesky_solve_kernel
from dexrobot_isaac_tpu_torch.ops import linalg
from dexrobot_isaac_tpu_torch.physics import types as tt
from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics
from dexrobot_isaac_tpu_torch.utils.kernel_build import CSRC
from tests.proc import run
from tests.test_torch_physics import PARAMS, _inputs

REL_TOL = 1e-5
P = ctypes.c_void_p


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_systems(b, seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, 26, 26))
    a = (r @ r.transpose(0, 2, 1) / 26 + np.diag(rng.uniform(0.01, 1.0, 26))).astype(np.float32)
    return a, rng.normal(size=(b, 26)).astype(np.float32)


@pytest.fixture(scope="module")
def systems():
    """{name: (A (B, 26, 26), b (B, 26))}: one substep's systems of the
    engine at the physics tests' contact-rich state, and random ones."""
    te = HandPhysics(params=tt.SimParams(**PARAMS), device="cpu")
    state, targets, spawn, dr = _inputs()
    seen = []

    def capture(A, rhs):
        seen.append((A.numpy().copy(), rhs.numpy().copy()))
        return linalg.spd_solve_plain(A, rhs)

    T = torch.as_tensor
    te._op_control_step(1, capture)(tt.PhysicsState(**{k: T(v) for k, v in state.items()}),
                                    T(targets), T(spawn), tt.DRSample(*map(T, dr)))
    return {"engine": seen[0], "random1": _random_systems(1, 2), "random5": _random_systems(5, 3),
            "random8": _random_systems(8, 0), "random300": _random_systems(300, 1)}


def _tpu_kernel(a, b):
    """The TPU kernel's body on (n, n, B) / (n, B) refs, run eagerly."""
    x = np.zeros((26, a.shape[0]), np.float32)
    _cholesky_solve_kernel(np.ascontiguousarray(a.transpose(1, 2, 0)),
                           np.ascontiguousarray(b.T), x, n=26)
    return x.T


@pytest.mark.parametrize("name", ["engine", "random8"])
def test_plain_matches_tpu_kernel_arithmetic(systems, name):
    a, b = systems[name]
    want = _tpu_kernel(a, b)
    assert _rel(want, _f64(a, b)) <= REL_TOL  # the TPU arithmetic itself, against float64
    got = linalg.spd_solve_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("name", ["engine", "random8", "random300"])
def test_wrapper_runs_plain_on_cpu(systems, name):
    a, b = systems[name]
    got = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.equal(got, linalg.spd_solve_plain(torch.as_tensor(a), torch.as_tensor(b)))
    assert _rel(got.numpy(), _f64(a, b)) <= REL_TOL


def test_wrapper_refuses_other_devices():
    """A tensor neither on the CPU nor on the card never reaches the plain
    version."""
    a = torch.empty(2, 26, 26, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        linalg.spd_solve(a, torch.empty(2, 26, device="meta"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_spd") / "spd_solve.so")
    run(["g++", "-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so,
         os.path.join(CSRC, "spd_solve.cu")], timeout=300)
    lib = ctypes.CDLL(so)
    lib.spd_solve_host.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int]
    lib.lane_order_host.argtypes = [ctypes.c_int]
    return lib


def _f64(a, b):
    return np.linalg.solve(a.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]


@pytest.mark.parametrize("name", ["engine", "random1", "random5", "random8", "random300"])
def test_kernel_source_matches_plain(host_lib, systems, name):
    a, b = (torch.as_tensor(v) for v in systems[name])
    x = torch.full_like(b, float("nan"))
    assert host_lib.spd_solve_dim() == 26
    assert host_lib.spd_solve_host(a.data_ptr(), b.data_ptr(), x.data_ptr(), a.shape[0], 26) == 0
    assert _rel(x.numpy(), linalg.spd_solve_plain(a, b).numpy()) <= REL_TOL
    assert _rel(x.numpy(), _tpu_kernel(a.numpy(), b.numpy())) <= REL_TOL
    assert _rel(x.numpy(), _f64(a.numpy(), b.numpy())) <= REL_TOL


def test_kernel_source_reads_only_the_lower_triangle(host_lib, systems):
    """The TPU kernel reads A[i][j] for i >= j only; so does the CUDA one."""
    a, b = (torch.as_tensor(v) for v in systems["random8"])
    junk = a.clone()
    iu = torch.triu_indices(26, 26, 1)
    junk[:, iu[0], iu[1]] = float("nan")
    x, y = torch.empty_like(b), torch.empty_like(b)
    host_lib.spd_solve_host(a.data_ptr(), b.data_ptr(), x.data_ptr(), 8, 26)
    host_lib.spd_solve_host(junk.data_ptr(), b.data_ptr(), y.data_ptr(), 8, 26)
    assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["engine", "random1", "random5", "random8", "random300"])
def test_kernel_source_independent_of_lane_order(host_lib, systems, name):
    """The host build with its lanes in forward and in reverse order gives
    the same bits: no warp phase reads what another lane writes in it."""
    a, b = (torch.as_tensor(v) for v in systems[name])
    out = []
    for reverse in (0, 1):
        x = torch.full_like(b, float("nan"))
        host_lib.lane_order_host(reverse)
        try:
            assert host_lib.spd_solve_host(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                           a.shape[0], 26) == 0
        finally:
            host_lib.lane_order_host(0)
        out.append(x)
    assert torch.isfinite(out[0]).all()
    assert torch.equal(out[0], out[1])

"""The learner's clip + Adam kernel pair (`csrc/clip_adam.cu`) held to its
plain version (`ops/clip_adam.py` `clip_adam_plain`) on the CPU.

A g++ host build of the `.cu` (its blocks' threads run as loops, each
warp's shuffle tree on an array, in the card's order) goes through the
wrapper's own table, checks, outputs and views (`run_kernels`). Leaves: the
shared (11 leaves) and the asymmetric (17) network at the README recipe's
widths (158 observations, 135 critic states, 18 actions, units
512-256-128); the clip engaged, not engaged, and off (`truncate_grads`
false); Adam's step 1, 2 and 1000.

The plain version runs here with an IEEE square root: torch's vectorized
CPU sqrt (AVX-512) is off by one ulp in ~0.6% of float32 inputs, whereas
torch's CUDA sqrt and the kernel's `__fsqrt_rn` round correctly, so on the
card the plain version's own sqrt is the IEEE one. A sqrt taken in float64
and rounded to float32 is the correctly rounded float32 sqrt.

- Gradients that are small multiples of a power of two make every sum of
  g*g exact in any order, so both sides reach the same norm: every output
  element is bitwise equal to the plain version's.
- Normal gradients: the norms agree within 1e-6 relative (only the order
  of summation differs), and given the kernel's norm the plain version's
  outputs equal the kernel's bit for bit.
- Two calls give the same bits; the count comes back + 1; the inputs are
  left as they were; a table past the cap, a leaf of another dtype, device
  or shape, a non-contiguous leaf and mismatched keys raise.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch.ops import clip_adam as ca
from dexrobot_isaac_tpu_torch.rl.ppo import PPOConfig, PPOLearner
from dexrobot_isaac_tpu_torch.utils.kernel_build import CSRC
from tests.proc import run

RECIPE = dict(num_actions=18, num_obs=158, num_envs=8, units=(512, 256, 128))
NETS = {"shared": 0, "asymmetric": 135}   # critic states
MAX_NORM = 1.0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_clip_adam") / "clip_adam.so")
    # g++ takes ~1 s for this file
    run(["g++", "-x", "c++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", so, os.path.join(CSRC, "clip_adam.cu")], timeout=120)
    lib = ctypes.CDLL(so)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    LL = ctypes.POINTER(ctypes.c_longlong)
    lib.clip_adam_host.argtypes = [LL, LL, I, P, P, P, P, P, P, P, I, D, D, D, D]
    return lib


@pytest.fixture(scope="module")
def shapes():
    """{net: {leaf: shape}} of the learner's params at the recipe's widths."""
    out = {}
    for net, states in NETS.items():
        learner = PPOLearner(PPOConfig(**RECIPE, num_states=states), None, device="cpu")
        out[net] = {k: v.shape for k, v in learner.init_state().params.items()}
    assert [len(v) for v in out.values()] == [11, 17]
    return out


@pytest.fixture
def ieee_sqrt(monkeypatch):
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


def _host(lib, *args, max_norm):
    """The kernel pair through the wrapper's table, on the host: (out, the
    norm launch 2 wrote, or None without the clip)."""
    seen = {}
    scratch = lib.clip_adam_scratch()

    def launch(*a):
        rc = lib.clip_adam_host(*a)
        seen["norm"] = ctypes.c_float.from_address(a[6] + 4 * (scratch - 1)).value
        return rc

    out = ca.run_kernels(launch, lib.clip_adam_max_leaves(), scratch, *args, max_norm)
    return out, (seen["norm"] if max_norm is not None else None)


def _inputs(shapes, seed, grads="normal", scale=1.0, step=1):
    """(params, grads, mu, nu, count, lr): normal params and moments (nu
    positive), grads normal or small multiples of 2**-6 (exact sums of
    squares), times `scale`; count = step - 1."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    params = {k: f(rng.normal(size=s)) for k, s in shapes.items()}
    if grads == "normal":
        g = {k: f(scale * rng.normal(size=s)) for k, s in shapes.items()}
    else:
        g = {k: f(scale * rng.integers(-4, 5, size=s) / 64) for k, s in shapes.items()}
    mu = {k: f(0.1 * rng.normal(size=s)) for k, s in shapes.items()}
    nu = {k: f(1e-3 * rng.random(size=s)) for k, s in shapes.items()}
    return (params, g, mu, nu, torch.tensor(step - 1, dtype=torch.int32),
            torch.tensor(3e-4, dtype=torch.float32))


def _bitwise(got, want):
    (gp, gc, gm, gn), (wp, wc, wm, wn) = got, want
    assert int(gc) == int(wc)
    for g, w in ((gp, wp), (gm, wm), (gn, wn)):
        assert list(g) == list(w)
        for k in w:
            assert g[k].shape == w[k].shape
            assert torch.equal(g[k].view(torch.int32), w[k].view(torch.int32)), k


# the clip engaged (||g|| ~ 28), not engaged (~ 0.22), and off
CLIPS = {"engaged": (1.0, MAX_NORM), "idle": (2.0 ** -7, MAX_NORM), "off": (1.0, None)}


@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("net", list(NETS))
def test_exact_norm_bitwise_equal_to_plain(host_lib, shapes, ieee_sqrt, net, clip, step):
    scale, max_norm = CLIPS[clip]
    args = _inputs(shapes[net], seed=step, grads="exact", scale=scale, step=step)
    before = ([{k: v.clone() for k, v in d.items()} for d in args[:4]]
              + [a.clone() for a in args[4:]])
    got, norm = _host(host_lib, *args, max_norm=max_norm)
    want = ca.clip_adam_plain(*args, max_norm)
    if max_norm is not None:
        plain_norm = float(ca.global_norm_plain(args[1]))
        assert norm == plain_norm
        assert (norm < max_norm) == (clip == "idle")
    _bitwise(got, want)
    assert int(got[1]) == step
    for was, now in zip(before, args):
        if isinstance(was, dict):
            assert all(torch.equal(was[k], now[k]) for k in was)
        else:
            assert torch.equal(was, now)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("net", list(NETS))
def test_normal_grads_given_the_kernels_norm(host_lib, shapes, ieee_sqrt, monkeypatch, net, clip):
    scale, max_norm = CLIPS[clip]
    args = _inputs(shapes[net], seed=7, scale=scale * 0.05, step=2)
    got, norm = _host(host_lib, *args, max_norm=max_norm)
    again, norm2 = _host(host_lib, *args, max_norm=max_norm)
    _bitwise(again, got)
    assert norm2 == norm
    if max_norm is not None:
        plain_norm = float(ca.global_norm_plain(args[1]))
        assert abs(norm - plain_norm) <= 1e-6 * plain_norm
        assert (norm < max_norm) == (clip == "idle")
        monkeypatch.setattr(ca, "global_norm_plain", lambda grads: torch.tensor(norm))
    _bitwise(got, ca.clip_adam_plain(*args, max_norm))


def test_wrapper_runs_plain_on_cpu(shapes):
    args = _inputs(shapes["shared"], seed=3)
    _bitwise(ca.clip_adam(*args, MAX_NORM), ca.clip_adam_plain(*args, MAX_NORM))


def test_wrapper_refuses_other_devices():
    """A tensor neither on the CPU nor on the card never reaches the plain
    version."""
    m = lambda: {"w": torch.empty(3, device="meta")}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ca.clip_adam(m(), m(), m(), m(), torch.empty((), dtype=torch.int32, device="meta"),
                     torch.empty((), device="meta"), MAX_NORM)


def test_refuses_what_the_kernels_do_not_take(host_lib, shapes):
    params, grads, mu, nu, count, lr = _inputs(shapes["shared"], seed=4)
    call = lambda *a: _host(host_lib, *a, max_norm=MAX_NORM)
    k = next(k for k, v in params.items() if v.dim() == 2)
    cap = host_lib.clip_adam_max_leaves()
    many = {f"w{i}": torch.ones(2) for i in range(cap + 1)}
    with pytest.raises(ValueError, match=f"1 to {cap} leaves"):
        call(many, many, many, many, count, lr)
    for bad, what in ((grads[k].double(), "float64"),
                      (grads[k].t().contiguous().t(), "contiguous False"),
                      (torch.empty(grads[k].shape, device="meta"), "meta"),
                      (grads[k].reshape(-1), "params")):
        with pytest.raises(ValueError, match=what):
            call(params, {**grads, k: bad}, mu, nu, count, lr)
    with pytest.raises(ValueError, match="same keys"):
        call(params, {kk: v for kk, v in grads.items() if kk != k}, mu, nu, count, lr)
    with pytest.raises(ValueError, match="count"):
        call(params, grads, mu, nu, count.long(), lr)
    # the launcher's own check, past the wrapper's
    n = cap + 1
    ptrs = (ctypes.c_longlong * (4 * n))(*([grads[k].data_ptr()] * 4 * n))
    sizes = (ctypes.c_longlong * n)(*([1] * n))
    assert host_lib.clip_adam_host(ptrs, sizes, n, *([None] * 7), 1, 1.0, 0.9, 0.999, 1e-8) == 1

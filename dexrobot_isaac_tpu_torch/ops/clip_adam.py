"""The learner's optimizer step, a CUDA kernel pair + its plain version.

optax's `chain(clip_by_global_norm(max_norm), adam)` followed by
`apply_updates`, which the JAX learner runs under jit (its
`rl/ppo.py` `_tx`), over every leaf of the network at once.
`rl/ppo.py` `_apply_updates` calls `clip_adam`:

- on CUDA tensors it launches `csrc/clip_adam.cu` (launch 1: a partial sum
  of g*g per block; launch 2: the global norm from those sums, the clip and
  Adam on every element of every leaf) or raises;
- on CPU tensors it runs `clip_adam_plain`, the eager per-leaf ops: the clip
  keeps g where ||g|| < max_norm and scales it by max_norm / ||g|| otherwise
  (no 1e-6 in the norm, unlike `torch.nn.utils.clip_grad_norm_`), then Adam
  with b1 0.9, b2 0.999 and eps 1e-8 outside the square root, at the
  learning rate `lr`.

Both take dicts of float32 leaves with the same keys and shapes (params,
grads and the two moments), the step count (() int32) and `lr` (() float32)
on one device, and `max_norm` (None: no clip), and return (new params,
count + 1, new mu, new nu) as new tensors, leaving the inputs as they were.
The kernel's new leaves are views of three flat buffers, one per dict. Its
arithmetic is the plain version's, element by element and in the same
order; only the order in which the norm is summed differs.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from dexrobot_isaac_tpu_torch.utils import kernel_build as kb

Leaves = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8


def global_norm_plain(grads: Leaves) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def clip_adam_plain(params: Leaves, grads: Leaves, mu: Leaves, nu: Leaves, count: torch.Tensor,
                    lr: torch.Tensor, max_norm: Optional[float]
                    ) -> Tuple[Leaves, torch.Tensor, Leaves, Leaves]:
    if max_norm is not None:
        g_norm = global_norm_plain(grads)
        keep = g_norm < max_norm
        grads = {k: torch.where(keep, g, (g / g_norm) * max_norm) for k, g in grads.items()}
    count = count + 1
    cf = count.float()
    bc1, bc2 = 1 - B1 ** cf, 1 - B2 ** cf
    mu = {k: (1 - B1) * g + B1 * mu[k] for k, g in grads.items()}
    nu = {k: (1 - B2) * (g * g) + B2 * nu[k] for k, g in grads.items()}
    new = {k: params[k] + (-lr) * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS))
           for k in params}
    return new, count, mu, nu


def _lib() -> ctypes.CDLL:
    lib = kb.load("clip_adam")
    if not getattr(lib, "_typed", False):
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        LL = ctypes.POINTER(ctypes.c_longlong)
        lib.clip_adam_launch.argtypes = [LL, LL, I, P, P, P, P, P, P, P, I, D, D, D, D, P]
        lib.clip_adam_max_leaves.argtypes = []
        lib.clip_adam_scratch.argtypes = []
        lib.max_leaves, lib.scratch = lib.clip_adam_max_leaves(), lib.clip_adam_scratch()
        lib._typed = True
    return lib


def clip_adam(params: Leaves, grads: Leaves, mu: Leaves, nu: Leaves, count: torch.Tensor,
              lr: torch.Tensor, max_norm: Optional[float] = None
              ) -> Tuple[Leaves, torch.Tensor, Leaves, Leaves]:
    """On `count`'s device: the plain version on the CPU, the kernel pair on
    the card (every tensor on that device, or it raises)."""
    if count.device.type == "cpu":
        return clip_adam_plain(params, grads, mu, nu, count, lr, max_norm)
    if count.device.type != "cuda":
        raise ValueError(f"clip_adam: expected CPU or CUDA tensors, got {count.device}")
    lib = _lib()
    stream = kb.stream_ptr(count.device)
    out = run_kernels(lambda *a: lib.clip_adam_launch(*a, stream), lib.max_leaves, lib.scratch,
                      params, grads, mu, nu, count, lr, max_norm)
    kb.LAUNCHES["clip_adam"] += 1 if max_norm is None else 2
    return out


def run_kernels(launch: Callable[..., int], max_leaves: int, scratch: int, params: Leaves,
                grads: Leaves, mu: Leaves, nu: Leaves, count: torch.Tensor, lr: torch.Tensor,
                max_norm: Optional[float]) -> Tuple[Leaves, torch.Tensor, Leaves, Leaves]:
    """The kernels' call through `launch` (the card's launcher on the current
    stream, or the host build's entry in the CPU tests): checks the leaves
    and builds their table, allocates the outputs (and `scratch` floats for
    the partial sums) on `count`'s device and splits them into leaves."""
    dev = count.device
    names = list(params)
    if not 1 <= len(names) <= max_leaves:
        raise ValueError(f"clip_adam takes 1 to {max_leaves} leaves, got {len(names)}")
    if not params.keys() == grads.keys() == mu.keys() == nu.keys():
        raise ValueError("clip_adam: params, grads, mu and nu must have the same keys")
    ptrs, sizes, shapes = [], [], []
    for k in names:
        shape = params[k].shape
        for t in (params[k], grads[k], mu[k], nu[k]):
            if (t.dtype != torch.float32 or t.device != dev or not t.is_contiguous()
                    or t.shape != shape):
                raise ValueError(f"clip_adam takes contiguous float32 leaves of one shape on "
                                 f"{dev}; leaf {k!r}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                                 f"contiguous {t.is_contiguous()}, params {tuple(shape)}")
            ptrs.append(t.data_ptr())
        sizes.append(params[k].numel())
        shapes.append(tuple(shape))
    for name, t, dtype in (("count", count, torch.int32), ("lr", lr, torch.float32)):
        if t.dtype != dtype or t.device != dev or t.numel() != 1:
            raise ValueError(f"clip_adam: {name} must be one {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    total = sum(sizes)
    p_out, mu_out, nu_out = (torch.empty(total, device=dev) for _ in range(3))
    partials = torch.empty(scratch, device=dev)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    n = len(names)
    kb.check(launch((ctypes.c_longlong * (4 * n))(*ptrs), (ctypes.c_longlong * n)(*sizes), n,
                    p_out.data_ptr(), mu_out.data_ptr(), nu_out.data_ptr(), partials.data_ptr(),
                    count.data_ptr(), count_out.data_ptr(), lr.data_ptr(),
                    int(max_norm is not None), 0.0 if max_norm is None else float(max_norm),
                    B1, B2, EPS), "clip_adam")

    def leaves(flat):  # view(*ints): a torch.Size argument costs the host twice as much
        return {k: v.view(*s) for k, v, s in zip(names, flat.split(sizes), shapes)}

    return leaves(p_out), count_out, leaves(mu_out), leaves(nu_out)

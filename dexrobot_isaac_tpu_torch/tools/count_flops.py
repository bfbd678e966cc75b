"""Semantic FLOPs per env control step of the plain step (the port of
`tools/count_flops.py`).

    python -m dexrobot_isaac_tpu_torch.tools.count_flops [task] [num_envs] [key=value ...]

Prints one JSON line: {"task", "num_envs", "flops_per_step",
"flops_per_env_step"}. The plain step (`make_env(..., device="cpu")`,
`env.step_fn` on the reset state with uniform random actions) is the
readable version K1 and K2 are held to, so its operations are the
algorithmic FLOPs of one control step: the numerator of the bench's MFU. It
always runs on the CPU, at a small batch (default 8 envs; the count scales
with the envs, bar a few ops on scalars). `key=value` arguments override
the task's config (e.g. `sim.substeps=1`).

Every aten op the step executes is counted under a `TorchDispatchMode`, so
every trip of every loop counts, each of the `physics_steps_per_control x
substeps` substeps included. The rule is XLA's `HloCostAnalysis`:

- 1 per output element for every elementwise op, compares, selects,
  bitwise ops and dtype converts included; transcendentals (exp, sin, cos,
  sqrt, a non-integer power, ...) are not FLOPs there (XLA counts them
  apart), and neither are copies, views, gathers, concatenations, fills
  and random draws;
- 2*M*N*K for a matrix product (`mm`, `bmm`);
- the input's elements for a reduction;
- n^3/3 for a Cholesky factor of an n x n matrix, and n^2 per right-hand
  side for a Cholesky solve; an `index_add` adds its sources;
- a cross product of 3-vectors, 3 per output element (6 multiplies and 3
  subtractions, as `jnp.cross` lowers).

The JAX tool counts a loop body once, not once per trip: XLA's cost analysis
of the compiled BlindGrasping step at 8 envs gives 135,184 FLOPs per env
step at the default 4 substeps x 4 physics steps, 134,920 at 1 substep x 4
physics steps and 140,643 at 1 x 1, though the default step runs 16
substeps and the last one 1. So its count, and the MFU that the JAX
`bench.py` prints from it, miss 15 of the 16 substeps. Its count is of the
compiled program, where XLA's CPU compiler has copied cheap producers into
each consumer fusion and the analysis counts every copy (the JAX FK: 3,899
FLOPs per env in the lowered program, 47,754 compiled); the lowered
program's count at 1 x 1, one trip and no copies, is 66,832 per env step,
against 73,874 here.
"""

from __future__ import annotations

import functools
import json
import sys
from typing import Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# XLA's transcendental opcodes: counted apart, not as FLOPs
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos", "tan",
                   "tanh", "sinh", "cosh", "asin", "acos", "atan", "atan2", "sqrt", "rsqrt",
                   "erf", "erfc", "sigmoid", "pow"}
# elementwise-tagged ops that move data without arithmetic
_NO_FLOPS = {"clone", "_to_copy", "copy", "fill", "lift_fresh", "zero", "detach", "alias"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _out_numel(out) -> int:
    if isinstance(out, (tuple, list)):
        return _numel(out[0]) if out else 0
    return _numel(out)


def _base(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def op_flops(func, args, kwargs, out) -> int:
    """FLOPs of one aten op, by the rule in the module docstring."""
    name = _base(func)
    tags = func.tags
    if func in (aten.mm.default, aten.bmm.default):
        return 2 * args[0].numel() * args[1].shape[-1]
    if name == "linalg_cross":
        return 3 * _out_numel(out)
    if name == "linalg_cholesky_ex":
        n = args[0].shape[-1]
        return args[0].numel() // (n * n) * n ** 3 // 3
    if name == "cholesky_solve":  # (rhs, factor)
        n = args[1].shape[-1]
        return args[0].numel() // n * n * n
    if name == "index_add":  # the additions of the sources
        return _numel(args[3])
    if name == "copy":  # a dtype convert into an existing tensor
        return _numel(args[0]) if args[0].dtype != args[1].dtype else 0
    if name == "_to_copy":
        dtype = kwargs.get("dtype")
        return _numel(args[0]) if dtype is not None and dtype != args[0].dtype else 0
    if torch.Tag.reduction in tags:
        return _numel(args[0])
    if torch.Tag.pointwise in tags:
        if name in _NO_FLOPS:
            return 0
        if name == "pow":
            e = args[1] if len(args) > 1 else None
            if isinstance(e, (int, float)) and float(e).is_integer() and 1 <= e <= 4:
                return (int(e) - 1) * _out_numel(out)  # XLA's integer_pow: multiplies
            return 0
        if name in _TRANSCENDENTAL:
            return 0
        return _out_numel(out)
    return 0


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of every aten op run under it (`flops`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.flops += op_flops(func, args, kwargs, out)
        return out


def count(task: str = "BlindGrasping", num_envs: int = 8, overrides: Sequence[str] = ()) -> Dict:
    """The FLOPs of one plain control step of `task` at `num_envs` envs on
    the CPU, with config `overrides` (counted once per process)."""
    return dict(_count(task, num_envs, tuple(overrides)))


@functools.lru_cache(maxsize=None)
def _count(task: str, num_envs: int, overrides: Tuple[str, ...]) -> Dict:
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    env = make_env(load_config([f"task={task}", f"numEnvs={num_envs}", *overrides]), seed=0,
                   device="cpu")
    state, _ = env.reset_fn()
    gen = torch.Generator().manual_seed(0)
    actions = torch.rand(num_envs, env.num_actions, generator=gen) * 2 - 1
    counter = FlopCounter()
    with torch.no_grad(), counter:
        env.step_fn(state, actions)
    return {"task": task, "num_envs": num_envs, "flops_per_step": float(counter.flops),
            "flops_per_env_step": counter.flops / num_envs}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in argv if "=" in a]
    pos = [a for a in argv if "=" not in a]
    task = pos[0] if pos else "BlindGrasping"
    n = int(pos[1]) if len(pos) > 1 else 8
    print(json.dumps(count(task, n, overrides)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

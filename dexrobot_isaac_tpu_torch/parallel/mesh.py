"""The process group: one rank per card, the env batch sharded over ranks.

The port's counterpart of `dexrobot_isaac_tpu/parallel/mesh.py` and of
`maybe_init_distributed` (`parallel/distributed.py:30-57` of the JAX
package). JAX spans the chips with a 1-D `data` mesh inside one program;
PyTorch runs one process per card, launched by `torchrun`, and joins them
with `torch.distributed`:

    torchrun --nproc_per_node=N -m dexrobot_isaac_tpu_torch.train ...

`init_distributed` reads torchrun's `env://` contract (`MASTER_ADDR`,
`MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`; a manual launch sets
the five itself) and returns a `Group`: the rank, the world size, the
rank's device (`cuda:LOCAL_RANK`, or the CPU) and the backend, which
follows the device: NCCL on the card, gloo on the CPU. Without the contract
it returns a single-process `Group` and nothing changes.

The collectives take a tensor or a dict of tensors and return new tensors
(a dict goes as one flat buffer per dtype, so one collective per dtype).
Without a process group each returns its input untouched; under one they
are always issued, even at world size 1. Every rank gets the same reduced
bits, so state computed from reduced values stays bitwise replicated.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

from dexrobot_isaac_tpu_torch.utils.device import resolve_device

CONTRACT = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
# rank r's generators start from seed + r * this (2^64 / golden ratio)
_RANK_STRIDE = 0x9E3779B97F4A7C15

Tensors = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank of a process group; `backend` None is a single process."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_slice(self, n_global: int) -> slice:
        """This rank's contiguous share of `n_global` envs. Raises unless
        they divide evenly: a multi-process launch has no fallback."""
        if n_global % self.world_size:
            raise ValueError(f"numEnvs={n_global} does not divide over {self.world_size} ranks")
        n = n_global // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def rank_seed(self, seed: int) -> int:
        """The seed of this rank's generators: `seed` itself on rank 0, so
        rank 0 draws what a single process draws (JAX folds the shard index
        into its keys, `envs/dexhand.py:222-225`)."""
        return (seed + self.rank * _RANK_STRIDE) % (1 << 64)

    # ------------------------------------------------------------------
    def all_reduce_mean(self, x: Tensors) -> Tensors:
        """The mean over the ranks (JAX `pmean`)."""
        return self._reduce(x, dist.ReduceOp.SUM, self.world_size)

    def all_reduce_sum(self, x: Tensors) -> Tensors:
        """The sum over the ranks (JAX `psum`)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x: Tensors) -> Tensors:
        """The maximum over the ranks (JAX `pmax`)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite `tensors` in place with rank 0's."""
        if not self.active:
            return
        tensors = list(tensors)
        for t, new in zip(tensors, _flat_op(tensors, lambda flat: dist.broadcast(flat, src=0))):
            t.copy_(new)

    def _reduce(self, x: Tensors, op, divisor: int = 1) -> Tensors:
        if not self.active:
            return x
        if isinstance(x, torch.Tensor):
            return self._reduce({"": x}, op, divisor)[""]

        def reduce(flat):
            dist.all_reduce(flat, op=op)
            if divisor != 1:
                flat.div_(divisor)

        return dict(zip(x, _flat_op(list(x.values()), reduce)))

    def close(self) -> None:
        """Leave the process group (no-op for a single process)."""
        if self.active and dist.is_initialized():
            dist.destroy_process_group()


def _flat_op(tensors: List[torch.Tensor], op) -> List[torch.Tensor]:
    """`op` (a collective, in place) on one flat copy of `tensors` per dtype:
    the results, shaped as `tensors`, which stay untouched."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        op(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def single_process(device) -> Group:
    """The group of a process launched on its own."""
    return Group(0, 1, resolve_device(device))


def _launched() -> bool:
    """Whether torchrun's contract is set. Raises on a partial one: WORLD_SIZE
    or RANK set without the other keys."""
    if not any(k in os.environ for k in ("WORLD_SIZE", "RANK")):
        return False
    missing = [k for k in CONTRACT if k not in os.environ]
    if missing:
        raise RuntimeError(f"incomplete torchrun environment: {', '.join(missing)} not set "
                           f"(a launch sets all of {', '.join(CONTRACT)})")
    return True


def launched_world_size() -> int:
    """The WORLD_SIZE of a torchrun launch, 1 without one."""
    return int(os.environ["WORLD_SIZE"]) if _launched() else 1


def init_distributed(device="cuda", backend: Optional[str] = None) -> Group:
    """Join the process group of a torchrun launch, or return a single-process
    group without one. On the card the rank's device is `cuda:LOCAL_RANK`
    and the backend NCCL, on the CPU gloo; `backend` overrides it (two ranks
    sharing one card over gloo, which NCCL refuses). A failed init raises.
    Called again in a process that has joined, it returns the same group."""
    if not _launched():
        return single_process(device)
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return Group(dist.get_rank(), dist.get_world_size(), device, dist.get_backend())


def free_port() -> int:
    """A free TCP port on localhost (for MASTER_PORT)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

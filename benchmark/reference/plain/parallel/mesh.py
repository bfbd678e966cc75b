"""A single process: the reference runs on one device, with no collectives."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.plain.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Group:
    rank: int
    world_size: int
    device: torch.device

    def shard_slice(self, n_global: int) -> slice:
        return slice(0, n_global)

    def rank_seed(self, seed: int) -> int:
        return seed % (1 << 64)

    def all_reduce_mean(self, x):
        return x

    def all_reduce_sum(self, x):
        return x

    def all_reduce_max(self, x):
        return x


def single_process(device) -> Group:
    return Group(0, 1, resolve_device(device))

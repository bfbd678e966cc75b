"""The benchmark's arithmetic: percentiles, the device's busy time
from kernel intervals, roofline and peak shares, the learner's FLOPs, and
the H100's published peaks."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates at the full
# 700 W power limit
H100_F32_PER_S = 67e12          # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12      # HBM3


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


def idle_share(intervals: Sequence[Tuple[float, float]], window: float) -> float:
    """Percent of a window of length `window` with no interval running."""
    return 100.0 * (1.0 - union_length(intervals) / window)


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """Percent of the H100's roofline: the least time the card could take
    (the larger of f32 operations over the f32 peak and bytes over the HBM
    rate) over the time taken."""
    return 100.0 * max(flops / H100_F32_PER_S, nbytes / H100_BYTES_PER_S) / seconds


def f32_mfu(flops_per_item: float, items_per_s: float) -> float:
    """Percent of the H100's f32 peak that `items_per_s` items of
    `flops_per_item` operations each would use."""
    return 100.0 * flops_per_item * items_per_s / H100_F32_PER_S


def mlp_macs(widths: Sequence[int]) -> int:
    """Multiply-adds of one sample through dense layers of these widths."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def learner_flops_per_sample(num_obs: int, num_states: int, num_actions: int,
                             units: Sequence[int], mini_epochs: int) -> int:
    """FLOPs of the actor-critic per trained env step: one rollout forward
    and `mini_epochs` forwards and backwards (a backward counted as twice
    its forward). With critic states the actor reads the obs and the critic
    the states, each through its own trunk; without them one trunk feeds
    both heads."""
    units = list(units)
    if num_states:
        macs = (mlp_macs([num_obs, *units, num_actions])
                + mlp_macs([num_states, *units, 1]))
    else:
        macs = mlp_macs([num_obs, *units]) + units[-1] * (num_actions + 1)
    forward = 2 * macs
    return forward * (1 + 3 * mini_epochs)


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """The largest gap between two norms of a leaf, over the larger of the
    reference's norm of that leaf and the median leaf's: (gap, leaf)."""
    med = statistics.median(ref.values())
    worst, name = 0.0, ""
    for k, r in ref.items():
        g = abs(prog[k] - r) / max(r, med)
        if g >= worst:
            worst, name = g, k
    return worst, name

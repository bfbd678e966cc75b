"""The harness's own spans and the device events of a profiled stretch.

Spans are intervals the harness records around its calls into the port.
A profiled stretch runs under an in-memory `torch.profiler` recording
device activity only (no chrome trace is written); its device operations
are set against the harness's spans and its own bounds on the wall clock,
which the profiler's events share."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

from benchmark import stats

class Spans:
    """Named spans the harness records around its calls into the port, kept
    in memory on the wall clock in ns (the clock of the profiler's device
    events)."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def mark(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((f"bench.{name}", t0, time.time_ns()))

    def mean_ms(self, name: str) -> Optional[float]:
        xs = [e - s for n, s, e in self.spans if n == f"bench.{name}"]
        return sum(xs) / len(xs) * 1e-6 if xs else None


class DeviceTrace:
    """What a profiled stretch recorded: device operations as (name, kind,
    start_ns, end_ns), the harness's annotations as (name, start_ns,
    end_ns), and the stretch's own bounds."""

    def __init__(self, ops, annotations, stretch: Tuple[int, int]):
        self.ops: List[Tuple[str, str, int, int]] = ops
        self.annotations: List[Tuple[str, int, int]] = annotations
        self.start_ns, self.end_ns = stretch

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def intervals(self) -> List[Tuple[int, int]]:
        return [(max(s, self.start_ns), min(e, self.end_ns)) for _, _, s, e in self.ops
                if e > self.start_ns and s < self.end_ns]

    @property
    def busy_s(self) -> float:
        return stats.union_length(self.intervals()) * 1e-9

    def idle_pct(self) -> Optional[float]:
        if not self.ops:
            return None
        return stats.idle_share(self.intervals(), self.end_ns - self.start_ns)

    def kernels(self, name_part: str) -> List[Tuple[str, str, int, int]]:
        return [op for op in self.ops if name_part in op[0]]

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, int] = collections.defaultdict(int)
        for name, _, s, e in self.ops:
            tot[name[:160]] += e - s
        return [[n, v * 1e-9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the device by the innermost harness annotation open
        on the host when each gap began."""
        gaps = stats.idle_gaps(self.intervals(), self.start_ns, self.end_ns)
        anns = sorted(self.annotations, key=lambda a: a[1])
        tot: Dict[str, int] = collections.defaultdict(int)
        for gs, ge in gaps:
            inner = [a for a in anns if a[1] <= gs < a[2]]
            name = min(inner, key=lambda a: a[2] - a[1])[0] if inner else "outside the spans"
            tot[name] += ge - gs
        return [[n, v * 1e-9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


def device_ops(prof) -> List[Tuple[str, str, int, int]]:
    """The profile's device operations: kernels, copies and fills."""
    from torch.autograd import DeviceType

    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name, kind = ev.name(), str(getattr(ev, "activity_type", lambda: "")())
        if "annotation" in kind or bool(getattr(ev, "is_user_annotation", lambda: False)()):
            continue
        start = _ns(ev, "start")
        ops.append((name, kind, start, start + _ns(ev, "duration")))
    return ops


@contextlib.contextmanager
def profiled(device, marks: Spans, out: list):
    """Profile the body as the stretch, device activity only (no host op
    is recorded, so the host's pace stays as in the window); appends its
    DeviceTrace to `out`. The stretch runs from a synchronized start to a
    synchronized end on the wall clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        t0 = time.time_ns()
        yield
        out.append(DeviceTrace([], marks.spans, (t0, time.time_ns())))
        return
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        yield
        torch.cuda.synchronize(device)
        t1 = time.time_ns()
    ops = device_ops(prof)
    if ops and (min(o[2] for o in ops) < t0 - 1_000_000 or max(o[3] for o in ops) > t1 + 1_000_000):
        raise RuntimeError("the profiler's device clock does not match the wall clock")
    out.append(DeviceTrace(ops, marks.spans, (t0, t1)))

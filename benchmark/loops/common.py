"""What the loops share: seeds, the port's kernel builds, the weights the
benchmark makes, snapshots of the port's fused state at checked steps, and
the record a run leaves for the readers and the judge."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark import stats
from benchmark.reference import judge


def sub_seed(seed: int, label: str) -> int:
    """A 31-bit seed for one use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{label}".encode()).digest()[:4], "little") >> 1


def build_kernels(config: Dict, device: torch.device) -> None:
    """Compile the port's kernel builds this cell launches, all at once
    (each only where its library is missing from the port's build dir)."""
    if device.type == "cuda":
        from dexrobot_isaac_tpu_torch.utils import kernel_build

        kernel_build.build_all(config["builds"])


def program_config(spec, device: torch.device, extra=()) -> Dict:
    """The port's config of the cell. On the CPU (the tests) the fused step
    is asked for: the CLI picks it by itself on the card only."""
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    return load_config([*spec.config["overrides"], *spec.traffic.get("overrides", []),
                        *(["device=cpu", "train.params.config.fused=on"] if device.type == "cpu"
                          else []), *extra])


def reference_env(spec, device: torch.device, seed: int):
    from benchmark.reference.plain.factory import make_env
    from benchmark.reference.plain.utils.config import load_config

    cfg = load_config([*spec.config["overrides"], *spec.traffic.get("overrides", [])])
    return make_env(cfg, seed=seed, device=device), cfg


def make_weights(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """The actor-critic's weights from the seed, drawn on the device in one
    call: each matrix normal with variance 1 / fan_in, clipped at two
    standard deviations; biases and the log-std zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    flat = torch.randn(sum(math.prod(s) for s in mats.values()), generator=gen, device=device)
    out, o = {}, 0
    for k, s in shapes.items():
        if k in mats:
            n = math.prod(s)
            out[k] = flat[o:o + n].reshape(s).clamp(-2.0, 2.0) / math.sqrt(s[1])
            o += n
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def clone_fused(fs):
    return dataclasses.replace(fs, **{f.name: getattr(fs, f.name).clone()
                                      for f in dataclasses.fields(fs)})


@dataclasses.dataclass
class Checked:
    """One checked step of the port's fused step: its state before, the
    actions, the reset draws it was handed, and what it returned."""

    pre: object
    actions: torch.Tensor
    samples: tuple = None
    post: object = None
    obs: Optional[torch.Tensor] = None
    rew: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None


def reset_draws(renv, fused, fs, n: int):
    """The reset draws of one checked step, made with the reference env's
    generator (`renv` only draws here; it steps after the window): the
    reference's pair for the judge, and the same values as the port's step
    takes them (`operands`, laid out by the port's `operand_rows`)."""
    samples = renv.draw_samples(n, fs.difficulty)
    return samples, fused.operand_rows(*samples, n, fs.rows_f.device)


def step_checks(checked: List[Checked], fused, renv, control: bool) -> Dict[str, float]:
    """The env-step numbers, each the worst over the checked steps; with
    `control`, the bfloat16 reference's in the port's place."""
    out: Dict[str, float] = {}
    for c in checked:
        pre = fused.unpack(c.pre)
        ref = judge.reference_step(renv, pre, c.actions, c.samples)
        cand = (judge.reference_step(renv, pre, c.actions, c.samples, "bf16") if control
                else (fused.unpack(c.post), c.obs, c.rew, c.done))
        for k, v in judge.step_numbers(renv, pre, c.actions, cand, ref).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


@dataclasses.dataclass
class Record:
    """What a run leaves: end-to-end numbers, the counts, the spans and
    device trace for the readers, and the judge of its outputs."""

    config: Dict
    traffic: Dict
    num_envs: int
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    judge: Callable[..., Dict[str, float]]
    release: Callable[[], None]
    spans: object = None
    device_trace: object = None
    stretch_steps: int = 0
    traced_rate: Optional[float] = None
    learner_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    diagnose: Optional[Callable[[], Dict]] = None


def window_p95_ms(events) -> float:
    """The 95th percentile of the intervals between consecutive events."""
    return stats.percentile([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])], 95)


def now() -> float:
    return time.perf_counter()

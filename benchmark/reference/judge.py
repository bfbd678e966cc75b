"""The comparisons that decide `correct`: one env step of the port against
the plain reference, from the port's own state before the step.

The reference steps the same state with the same actions and the same
reset draws (the benchmark draws them with the reference env's generator
and hands them to both sides) and judges what the port returned: the
observations, rewards and dones of every env, the next state of every env
that did not reset, and the new pose of every env that did. Envs that
reset are also held to the masked reset itself: zero velocities, step
count and previous actions, exactly. The control (`precision="bf16"`) is
the reference in the port's place, its inputs and outputs rounded to
bfloat16."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from benchmark.reference.plain.envs.types import EnvState
from benchmark.reference.plain.physics.types import DRSample, PhysicsState

PHYSICS = ("q", "qd", "box_pos", "box_quat", "box_linvel", "box_angvel",
           "box2_pos", "box2_quat", "box2_linvel", "box2_angvel")
VELOCITIES = ("qd", "box_linvel", "box_angvel", "box2_linvel", "box2_angvel")


def _fields(obj) -> Dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _round(x, precision: str):
    if precision == "bf16" and isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).float()
    if isinstance(x, dict):
        return {k: _round(v, precision) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{k: _round(v, precision) for k, v in _fields(x).items()})
    return x


def as_reference_state(state, precision: str = "f32") -> EnvState:
    """The reference's EnvState holding the tensors of an EnvState of the
    port (read field by field, by name)."""
    kw = {k: _round(v, precision) for k, v in _fields(state).items()}
    kw["physics"] = PhysicsState(**{k: _round(v, precision)
                                    for k, v in _fields(state.physics).items()})
    kw["dr"] = DRSample(**_fields(state.dr))
    return EnvState(**kw)


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| / (1 + |r|); 0 over no elements."""
    if p.numel() == 0:
        return 0.0
    return float(((p.double() - r.double()).abs() / (1.0 + r.double().abs())).max())


def reference_step(renv, state, actions, samples, precision: str = "f32"):
    """The plain step of `state` (an EnvState of the port) under `actions`
    and the reset draws `samples` (`renv.draw_samples`' pair, as the port's
    step took them): (next EnvState, obs, reward, done)."""
    rstate = as_reference_state(state, precision)
    actions = _round(actions, precision)
    samples = tuple(_round(x, precision) for x in samples)
    with torch.no_grad():
        new, obs, rew, done, _ = renv._step(rstate, actions, *samples, renv._plain_control_step)
    if precision == "bf16":
        obs, rew = _round(obs, precision), _round(rew, precision)
        new = dataclasses.replace(new, physics=PhysicsState(**{
            k: _round(v, precision) for k, v in _fields(new.physics).items()}))
    return new, obs, rew, done


def physics_gap(new_p, new_r, rows) -> float:
    """The widest rel_gap of the physics state over the envs `rows`."""
    gap = 0.0
    for k in PHYSICS:
        p, r = getattr(new_p.physics, k, None), getattr(new_r.physics, k, None)
        if p is not None and r is not None:
            gap = max(gap, rel_gap(p[rows], r[rows]))
    return gap


def step_numbers(renv, pre, actions, out, ref) -> Dict[str, float]:
    """Judge one step. `pre`: the port's EnvState before the step; `out`:
    (next EnvState, obs, reward, done) as the port returned them; `ref`:
    the reference's."""
    new_p, obs_p, rew_p, done_p = out
    new_r, obs_r, rew_r, done_r = ref
    done_p, done_r = done_p.bool(), done_r.bool()
    agree = done_p == done_r
    return {
        "obs_gap": rel_gap(obs_p[agree], obs_r[agree]),
        "rew_gap": rel_gap(rew_p[agree], rew_r[agree]),
        "done_mismatch": float((~agree).sum()),
        "state_gap": physics_gap(new_p, new_r, agree & ~done_r),
        "reset_pose_gap": physics_gap(new_p, new_r, agree & done_r),
        "reset_gap": reset_gap(renv, new_p, done_p),
    }


def reset_gap(renv, new, done) -> float:
    """How far the envs that reset are from a masked reset: the largest
    velocity, step count or previous action that is not zero."""
    if not bool(done.any()):
        return 0.0
    gap = max(float(new.episode_step_count[done].abs().max()),
              float(new.prev_actions[done].abs().max()))
    for k in VELOCITIES:
        v = getattr(new.physics, k, None)
        if v is not None:
            gap = max(gap, float(v[done].abs().max()))
    return gap

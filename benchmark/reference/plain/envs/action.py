"""Action pipeline: rule -> post-action filters -> 18 -> 26 coupling (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/action.py`: the builtin
rules (position, position_delta) and filters (velocity_clamp,
position_clamp), and a task's custom action rule and filters. Static limits,
max deltas and the coupling map are built once from the model and config.

A custom action rule `fn(pl, active_prev, active_rule, actions)` replaces
the control mode's rule; custom filters `fn(pl, active_prev, active_rule,
targets)` run after the builtin ones. `active_rule` is the previous step's
pre-action rule output (`EnvState.active_rule_targets`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.plain.constants import (
    ACTIVE_FINGER_DOF_INDICES,
    DOF_INDEX,
    FINGER_COUPLING_MAP,
    NUM_BASE_DOFS,
    NUM_DOFS,
)
from benchmark.reference.plain.models.dexhand021 import HandModel

ACTIVE_IDX = list(range(NUM_BASE_DOFS)) + list(ACTIVE_FINGER_DOF_INDICES)
# (pl, active_prev (N, 18), active_rule (N, 18), actions (N, A)) -> targets (N, 18)
ActionRule = Callable[..., torch.Tensor]
# (pl, active_prev, active_rule, targets) -> targets, all (N, 18)
PostActionFilter = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ActionPipeline:
    control_mode: str                 # "position" | "position_delta"
    policy_controls_base: bool
    policy_controls_fingers: bool
    num_actions: int
    active_lower: np.ndarray          # (18,) float32
    active_upper: np.ndarray          # (18,)
    max_deltas: np.ndarray            # (18,) control_dt * per-component vel limit
    coupling_src: np.ndarray          # (26,) int: full DOF d <- active[src[d]]
    coupling_scale: np.ndarray        # (26,) float32 (0 = pinned at 0)
    post_action_filters: Tuple[str, ...] = ("velocity_clamp", "position_clamp")
    custom_action_rule: Optional[ActionRule] = None
    custom_filters: Tuple[PostActionFilter, ...] = ()


def build_action_pipeline(
    model: HandModel,
    control_mode: str,
    control_dt: float,
    policy_controls_base: bool = True,
    policy_controls_fingers: bool = True,
    max_base_linear_velocity: float = 0.5,
    max_base_angular_velocity: float = 1.5,
    max_finger_joint_velocity: float = 1.0,
    custom_action_rule: Optional[ActionRule] = None,
    custom_filters: Sequence[PostActionFilter] = (),
) -> ActionPipeline:
    if control_mode not in ("position", "position_delta"):
        raise ValueError(f"Unknown control mode: {control_mode}")
    max_deltas = control_dt * np.array(
        [max_base_linear_velocity] * 3
        + [max_base_angular_velocity] * 3
        + [max_finger_joint_velocity] * 12
    )
    src = np.zeros(NUM_DOFS, dtype=np.int64)
    scale = np.zeros(NUM_DOFS)
    for d in range(NUM_BASE_DOFS):
        src[d], scale[d] = d, 1.0
    for control, pairs in FINGER_COUPLING_MAP.items():
        for joint, s in pairs:
            src[DOF_INDEX[joint]] = NUM_BASE_DOFS + control
            scale[DOF_INDEX[joint]] = s
    return ActionPipeline(
        control_mode=control_mode,
        policy_controls_base=policy_controls_base,
        policy_controls_fingers=policy_controls_fingers,
        num_actions=6 * policy_controls_base + 12 * policy_controls_fingers,
        active_lower=np.asarray(model.lower_limit[ACTIVE_IDX], dtype=np.float32),
        active_upper=np.asarray(model.upper_limit[ACTIVE_IDX], dtype=np.float32),
        max_deltas=np.asarray(max_deltas, dtype=np.float32),
        coupling_src=src,
        coupling_scale=np.asarray(scale, dtype=np.float32),
        custom_action_rule=custom_action_rule,
        custom_filters=tuple(custom_filters),
    )


def _limits(pl: ActionPipeline, dev):
    return (torch.as_tensor(pl.active_lower, device=dev),
            torch.as_tensor(pl.active_upper, device=dev),
            torch.as_tensor(pl.max_deltas, device=dev))


def _policy_segments(pl: ActionPipeline, actions):
    """[(active-target slice, the policy's actions for it)]: the base's 6
    and/or the fingers' 12."""
    segs, ofs = [], 0
    if pl.policy_controls_base:
        segs.append((slice(0, 6), actions[:, 0:6]))
        ofs = 6
    if pl.policy_controls_fingers:
        segs.append((slice(6, 18), actions[:, ofs:ofs + 12]))
    return segs


def position_action_rule(pl: ActionPipeline, active_prev, active_rule, actions):
    """Absolute mode: [-1, 1] scaled to the active limits; segments the
    policy does not control keep the rule's targets."""
    lo, hi, _ = _limits(pl, actions.device)
    t = active_rule.clone()
    for sl, a in _policy_segments(pl, actions):
        t[:, sl] = (a + 1.0) * 0.5 * (hi[sl] - lo[sl]) + lo[sl]
    return t


def position_delta_action_rule(pl: ActionPipeline, active_prev, active_rule, actions):
    """Relative mode: prev + action * max_delta, clamped to the limits."""
    lo, hi, md = _limits(pl, actions.device)
    t = active_rule.clone()
    for sl, a in _policy_segments(pl, actions):
        t[:, sl] = active_prev[:, sl] + a * md[sl]
    return torch.minimum(torch.maximum(t, lo), hi)


def _velocity_clamp(pl, prev, rule, t):
    _, _, md = _limits(pl, t.device)
    return prev + torch.minimum(torch.maximum(t - prev, -md), md)


def _position_clamp(pl, prev, rule, t):
    lo, hi, _ = _limits(pl, t.device)
    return torch.minimum(torch.maximum(t, lo), hi)


BUILTIN_FILTERS = {"velocity_clamp": _velocity_clamp, "position_clamp": _position_clamp}


def process_actions(pl: ActionPipeline, actions, active_prev, active_rule):
    """(N, num_actions) actions -> (full_dof_targets (N, 26), active targets
    (N, 18)). `active_rule` is the previous step's pre-action rule output."""
    if pl.custom_action_rule is not None:
        rule = pl.custom_action_rule
    elif pl.control_mode == "position":
        rule = position_action_rule
    else:
        rule = position_delta_action_rule
    t = rule(pl, active_prev, active_rule, actions)
    for name in pl.post_action_filters:
        if name not in BUILTIN_FILTERS:
            raise ValueError(f"unknown post-action filter {name}")
        t = BUILTIN_FILTERS[name](pl, active_prev, active_rule, t)
    for fn in pl.custom_filters:
        t = fn(pl, active_prev, active_rule, t)
    return apply_coupling(pl, t), t


def apply_coupling(pl: ActionPipeline, active_targets: torch.Tensor) -> torch.Tensor:
    """18 active targets -> 26 full-DOF targets (static gather and scale)."""
    dev = active_targets.device
    return active_targets[..., torch.as_tensor(pl.coupling_src, device=dev)] * torch.as_tensor(
        pl.coupling_scale, device=dev)


def extract_active_targets(full_dof: torch.Tensor) -> torch.Tensor:
    """Inverse of the coupling for reset re-sync: base DOFs + the primary
    joint of each finger control."""
    return full_dof[..., ACTIVE_IDX]

"""Rule-based controllers for the DOF groups the policy does not control
(torch): the port of `dexrobot_isaac_tpu/envs/rule_based.py`.

When `policy_controls_hand_base` or `policy_controls_fingers` is false, a
task's pre-action rule produces the targets of those segments
(`make_pre_action_rule`); they then flow through the same filters and
coupling as policy actions (envs/action.py). The reference's
RuleBasedController (components/action/rule_based_controller.py:29-161) and
its harness's circular base and adaptive grasp (examples/dexhand_test.py:
107-240).

A controller is `fn(t_seconds (N,), obs_dict, targets_segment) ->
targets_segment`, with `t_seconds` each env's episode time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

Controller = Callable[[torch.Tensor, Dict, torch.Tensor], torch.Tensor]

# finger control -> contact sensor (thumb, index, middle, ring, pinky distal
# links); the spread control (3) has none
_CONTROL_TO_FINGER = (0, 0, 0, -1, 1, 1, 2, 2, 3, 3, 4, 4)


def make_pre_action_rule(base_controller: Optional[Controller] = None,
                         finger_controller: Optional[Controller] = None):
    """A pre-action rule that overwrites the base (first 6) and/or finger
    (last 12) active targets with the controllers' outputs."""

    def rule(active_prev_targets: torch.Tensor, obs_dict: Dict) -> torch.Tensor:
        t = obs_dict["episode_time"][:, 0]
        out = active_prev_targets.clone()
        if base_controller is not None:
            out[:, :6] = base_controller(t, obs_dict, active_prev_targets[:, :6])
        if finger_controller is not None:
            out[:, 6:] = finger_controller(t, obs_dict, active_prev_targets[:, 6:])
        return out

    return rule


def circular_base_motion(radius: float = 0.1, period: float = 4.0,
                         z_amplitude: float = 0.0) -> Controller:
    """The base on a horizontal circle through its start point."""

    def controller(t, obs_dict, targets):
        phase = 2 * math.pi * t / period
        out = targets.clone()
        out[:, 0] = radius * torch.cos(phase) - radius
        out[:, 1] = radius * torch.sin(phase)
        if z_amplitude:
            out[:, 2] = z_amplitude * torch.sin(phase)
        return out

    return controller


def adaptive_grasp(close_rate: float = 0.5, force_threshold: float = 1.0,
                   control_dt: float = 0.02) -> Controller:
    """Each finger control closes at `close_rate` rad/s while its fingertip
    reports no contact and holds once it does; the spread stays put. Pass
    the env's control_dt for the right rate at other timings."""

    def controller(t, obs_dict, targets):
        contact = obs_dict["contact_binary"]  # (N, 5)
        idx = torch.tensor(_CONTROL_TO_FINGER, device=contact.device)
        gate = torch.where(idx < 0, torch.zeros_like(contact[:, :1]),
                           1.0 - contact[:, idx.clamp(0, 4)])
        return targets + gate * close_rate * control_dt

    return controller

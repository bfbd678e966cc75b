"""Task plugin contract (torch): the port's counterpart of
`dexrobot_isaac_tpu/envs/tasks/api.py`.

A task is a bundle of batched functions over the env state: `compute_step`
(task observations, task-state update, success/failure criteria and reward
terms, in the upstream order) and `reset_task` (per-env reset samples drawn
from a `torch.Generator`). Task temporal state lives in
`EnvState.task_states`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from benchmark.reference.plain.physics.types import SimParams


@dataclasses.dataclass
class TaskStep:
    task_obs: Dict[str, torch.Tensor]
    task_states: Dict[str, torch.Tensor]
    success_criteria: Dict[str, torch.Tensor]
    failure_criteria: Dict[str, torch.Tensor]
    reward_terms: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TaskReset:
    dof_pos: torch.Tensor                       # (N, 26)
    box_pos: Optional[torch.Tensor] = None      # (N, 3)
    box_quat: Optional[torch.Tensor] = None     # (N, 4)
    task_states: Optional[Dict[str, torch.Tensor]] = None
    # the second free box (SimParams.has_box2 scenes only)
    box2_pos: Optional[torch.Tensor] = None     # (N, 3)
    box2_quat: Optional[torch.Tensor] = None    # (N, 4)


def detect_finger_box_contacts(obs_dict, box_contact_force, box_pos, box_size,
                               contact_binary_threshold) -> torch.Tensor:
    """Per-finger box contact: finger contact AND box contact AND
    fingerpad-to-center proximity < sqrt(3)*size/2*1.2. (N, 5) bool."""
    n = box_pos.shape[0]
    box_has = torch.linalg.vector_norm(box_contact_force, dim=-1) > contact_binary_threshold
    pads = obs_dict["fingerpad_poses_world"].reshape(n, 5, 7)[:, :, :3]
    dist = torch.linalg.vector_norm(pads - box_pos[:, None, :], dim=-1)
    proximity = dist < (math.sqrt(3.0) * box_size / 2.0 * 1.2)
    return (obs_dict["contact_binary"] > 0.5) & box_has[:, None] & proximity


def symmetric_angle_error(angle, target, period: float) -> torch.Tensor:
    """Signed shortest error modulo `period` (a cube's yaw repeats every
    quarter turn). torch.round rounds half to even, as jnp.round does."""
    err = angle - target
    return err - period * torch.round(err / period)


def curriculum_scale(difficulty, min_fraction: float, enabled: bool = True):
    if not enabled or difficulty is None:
        return 1.0
    return min_fraction + (1.0 - min_fraction) * torch.clamp(difficulty, 0.0, 1.0)


class DexTask:
    """Base task: no-op everywhere."""

    name = "BaseTask"

    def __init__(self, task_cfg: Dict[str, Any]):
        self.cfg = task_cfg

    def configure_scene(self, params: SimParams) -> SimParams:
        return params

    def init_task_states(self, num_envs: int, device) -> Dict[str, torch.Tensor]:
        return {}

    def compute_step(self, obs_dict, task_states, physics, kin, body_contact_force,
                     box_contact_force, control_dt, box2_contact_force=None) -> TaskStep:
        """`box2_contact_force` is passed only in two-box scenes."""
        return TaskStep({}, task_states, {}, {}, {})

    def reset_task(self, gen: torch.Generator, num_envs: int, default_dof_pos,
                   difficulty=None, project: bool = True) -> TaskReset:
        return TaskReset(dof_pos=default_dof_pos[None].repeat(num_envs, 1))

    def project_spawn(self, dof_pos):
        """Spawn-validity projection of sampled reset poses (none here)."""
        return dof_pos

    # static schema: task observation dims, criteria and reward-term names
    obs_dims: Dict[str, int] = {}
    success_criteria: tuple = ()
    failure_criteria: tuple = ()
    reward_terms: tuple = ()

    # optional action hooks (envs/dexhand.py, envs/action.py), run on the
    # unfused step; the fused step declines them:
    # pre_action_rule(active_prev_targets, obs_dict) -> (N, 18) rule targets
    pre_action_rule = None
    # custom_action_rule(pl, active_prev, active_rule, actions) -> (N, 18)
    custom_action_rule = None
    # each fn(pl, active_prev, active_rule, targets) -> (N, 18)
    custom_post_filters = ()

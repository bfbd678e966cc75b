"""Environment state (torch): the port's counterpart of
`dexrobot_isaac_tpu/envs/types.py`.

One dataclass of tensors threaded through the step function, leading dim =
num_envs. The JAX state's `rng` key has no leaf here: the port's env owns a
`torch.Generator` on its device instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from benchmark.reference.plain.physics.types import DRSample, PhysicsState


@dataclasses.dataclass
class EnvState:
    physics: PhysicsState
    full_dof_targets: torch.Tensor      # (N, 26)
    active_prev_targets: torch.Tensor   # (N, 18)
    active_rule_targets: torch.Tensor   # (N, 18)
    prev_actions: torch.Tensor          # (N, num_actions)
    prev_dof_pos: torch.Tensor          # (N, 26)
    contact_duration_steps: torch.Tensor  # (N, n_contact) int32
    prev_contact_binary: torch.Tensor     # (N, n_contact) float32
    episode_step_count: torch.Tensor      # (N,) int32
    body_contact_force: torch.Tensor      # (N, B, 3)
    prev_finger_dof_vel: torch.Tensor   # (N, 20)
    prev_hand_vel: torch.Tensor         # (N, 3)
    prev_hand_ang_vel: torch.Tensor     # (N, 3)
    prev_contacts: torch.Tensor         # (N, n_contact) bool
    success_flags: Dict[str, torch.Tensor]
    failure_flags: Dict[str, torch.Tensor]
    consecutive_successes: torch.Tensor  # () int32
    task_states: Dict[str, torch.Tensor]
    dr: DRSample
    difficulty: torch.Tensor             # () float32

"""BoxPushing: push the box to a sampled target on the ground (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/tasks/box_pushing.py`.
The box rests on the ground in front of the hand and each episode samples a
target xy at a random direction and distance from it; the policy pushes the
box there (lifting it fails the episode) and keeps it there.

Success: the box centre within `position_tolerance` of the target, slower
than `rest_speed_tolerance`, held `hold_duration_threshold` seconds.
Failures: `box_lifted` (the centre more than `lift_tolerance` above its rest
height) and `box_lost` (farther from the target than it started, plus
`max_overshoot`). With `curriculum.enabled` the target distance scales with
the runtime difficulty.

`compute_step` is the plain version of the task step that the fused CUDA
kernel (`csrc/fused_step.cu`, the `fused_step_pushing` build) carries per
env. `target_xy` and the distances are sampled by `reset_task`, so the
kernel takes them from the reset rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from dexrobot_isaac_tpu_torch.envs.tasks.api import (
    DexTask,
    TaskReset,
    TaskStep,
    curriculum_scale,
    detect_finger_box_contacts,
)
from dexrobot_isaac_tpu_torch.envs.tasks.box_reorientation import (
    _random_hand_pose,
    _uniform,
    _yaw_quat,
)
from dexrobot_isaac_tpu_torch.physics.types import SimParams


class BoxPushingTask(DexTask):
    name = "BoxPushing"
    obs_dims = {
        "object_pos": 3, "object_quat": 4, "object_vel": 3, "target_xy": 2, "to_target": 2,
        "dist_to_target": 1, "finger_to_object_distances": 5, "fingers_on_box": 5,
        "hold_duration": 1,
    }
    success_criteria = ("push_success",)
    failure_criteria = ("box_lost", "box_lifted")
    reward_terms = ("distance_tracking", "distance_delta", "fingerpad_proximity",
                    "finger_contact", "target_hold")

    def __init__(self, task_cfg: Dict[str, Any]):
        super().__init__(task_cfg)
        c = task_cfg
        box = c.get("box", {})
        self.box_size = float(box.get("size", 0.05))
        self.box_mass = float(box.get("mass", 0.1))
        self.box_friction = float(box.get("friction", 1.0))
        self.box_xy_range = float(box.get("initial_position", {}).get("xy_range", 0.02))
        self.box_z = float(box.get("initial_position", {}).get("z", 0.027))
        tgt = c.get("target_distance", {})
        self.target_dist_min = float(tgt.get("min", 0.05))
        self.target_dist_max = float(tgt.get("max", 0.12))
        self.position_tolerance = float(c.get("position_tolerance", 0.02))
        self.rest_speed_tolerance = float(c.get("rest_speed_tolerance", 0.1))
        self.hold_duration_threshold = float(c.get("hold_duration_threshold", 0.5))
        self.max_overshoot = float(c.get("max_overshoot", 0.1))
        self.lift_tolerance = float(c.get("lift_tolerance", 0.05))
        self.contact_binary_threshold = float(c.get("contact_binary_threshold", 0.1))
        rc = c.get("reward_calculation", {})
        self.distance_decay = float(rc.get("distance_decay", 15.0))
        self.proximity_decay = float(rc.get("proximity_decay", 10.0))
        self.hand_translation_range = float(c.get("hand_translation_range", 0.05))
        self.hand_rotation_range = float(c.get("hand_rotation_range", 0.2))
        self.finger_range = float(
            c.get("finger_randomization", {}).get("other_finger_range", 0.3))
        cur = c.get("curriculum", {})
        self.curriculum_enabled = bool(cur.get("enabled", False))
        self.curriculum_min_fraction = float(cur.get("min_fraction", 0.4))

    # ------------------------------------------------------------------
    def configure_scene(self, params: SimParams) -> SimParams:
        return dataclasses.replace(params, has_box=True, box_size=self.box_size,
                                   box_mass=self.box_mass, box_friction=self.box_friction)

    def init_task_states(self, num_envs: int, device) -> Dict[str, torch.Tensor]:
        n = num_envs
        return {
            "target_xy": torch.zeros(n, 2, device=device),
            "initial_dist": torch.zeros(n, device=device),
            "prev_dist": torch.zeros(n, device=device),
            "hold_duration_steps": torch.zeros(n, dtype=torch.int32, device=device),
        }

    # ------------------------------------------------------------------
    def compute_step(self, obs_dict, task_states, physics, kin, body_contact_force,
                     box_contact_force, control_dt, box2_contact_force=None) -> TaskStep:
        n = physics.q.shape[0]
        ts = dict(task_states)
        box_pos, box_vel = physics.box_pos, physics.box_linvel
        to_target = ts["target_xy"] - box_pos[:, :2]
        dist = torch.linalg.vector_norm(to_target, dim=-1)
        speed = torch.linalg.vector_norm(box_vel, dim=-1)

        obs: Dict[str, torch.Tensor] = {
            "object_pos": box_pos, "object_quat": physics.box_quat, "object_vel": box_vel,
            "target_xy": ts["target_xy"], "to_target": to_target,
            "dist_to_target": dist[:, None],
        }
        pads = obs_dict["fingerpad_poses_world"].reshape(n, 5, 7)[:, :, :3]
        d_f2o = torch.linalg.vector_norm(pads - box_pos[:, None, :], dim=-1)
        obs["finger_to_object_distances"] = d_f2o
        fb = detect_finger_box_contacts(obs_dict, box_contact_force, box_pos, self.box_size,
                                        self.contact_binary_threshold)
        obs["fingers_on_box"] = fb.float()

        at_target = (dist < self.position_tolerance) & (speed < self.rest_speed_tolerance)
        steps = torch.where(at_target, ts["hold_duration_steps"] + 1,
                            torch.zeros_like(ts["hold_duration_steps"]))
        ts["hold_duration_steps"] = steps
        obs["hold_duration"] = (steps.float() * control_dt)[:, None]

        threshold_steps = int(round(self.hold_duration_threshold / control_dt))
        successes = {"push_success": steps >= threshold_steps}
        failures = {
            "box_lost": dist > ts["initial_dist"] + self.max_overshoot,
            "box_lifted": box_pos[:, 2] > self.box_z + self.lift_tolerance,
        }
        r: Dict[str, torch.Tensor] = {
            "distance_tracking": torch.exp(-self.distance_decay * dist),
            # dense improvement signal: previous distance minus current distance
            "distance_delta": ts["prev_dist"] - dist,
            "fingerpad_proximity": torch.exp(-self.proximity_decay * d_f2o.amin(dim=1)),
            "finger_contact": fb.any(dim=1).float(),
            "target_hold": at_target.float(),
        }
        ts["prev_dist"] = dist
        return TaskStep(obs, ts, successes, failures, r)

    # ------------------------------------------------------------------
    def reset_task(self, gen: torch.Generator, num_envs: int, default_dof_pos,
                   difficulty=None, project: bool = True) -> TaskReset:
        """Uniform draws from `gen` (on its device): the box's xy and yaw, the
        target's direction and distance (scaled by the curriculum when it is
        on), the hand's translation, rotation and fingers. No spawn
        projection."""
        n, dev = num_envs, gen.device
        if difficulty is not None:
            difficulty = torch.as_tensor(difficulty, dtype=torch.float32, device=dev)
        xy = (_uniform(gen, n, 2) * 2 - 1) * self.box_xy_range
        box_pos = torch.cat([xy, torch.full((n, 1), self.box_z, device=dev)], dim=-1)
        yaw = (_uniform(gen, n) * 2 - 1) * math.pi
        scale = curriculum_scale(difficulty, self.curriculum_min_fraction,
                                 self.curriculum_enabled)
        theta = _uniform(gen, n) * 2.0 * math.pi
        mag = (self.target_dist_min
               + _uniform(gen, n) * (self.target_dist_max - self.target_dist_min)) * scale
        target_xy = xy + torch.stack([mag * torch.cos(theta), mag * torch.sin(theta)], dim=-1)
        dof = _random_hand_pose(self, gen, n, default_dof_pos)
        ts = self.init_task_states(n, dev)
        ts["target_xy"] = target_xy
        dist0 = torch.linalg.vector_norm(target_xy - xy, dim=-1)
        ts["initial_dist"] = dist0
        # the delta reward's baseline: the true initial distance
        ts["prev_dist"] = dist0
        return TaskReset(dof_pos=dof, box_pos=box_pos, box_quat=_yaw_quat(yaw), task_states=ts)

"""BoxReorientation: turn the box in place to a target yaw (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/tasks/box_reorientation.py`.
The box rests on the ground in front of the hand and each episode samples a
target yaw; the policy spins the box with its fingers, keeping it near where
it started and on the ground. The yaw error counts modulo
2*pi/`yaw_symmetry` (a cube looks the same after a quarter turn).

Success: |yaw error| < `yaw_tolerance` with the box's xy drift below
`position_drift_tolerance`, held `align_duration_threshold` seconds.
Failures: `box_pushed_away` (drift > `max_drift`) and `box_lifted` (the box
centre more than `lift_tolerance` above its rest height).

`compute_step` is the plain version of the task step that the fused CUDA
kernel (`csrc/fused_step.cu`, the `fused_step_reorient` build) carries per
env; its constants come from this object. Every task state is sampled by
`reset_task`, so the kernel takes them from the reset rows.
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
    detect_finger_box_contacts,
    symmetric_angle_error,
)
from dexrobot_isaac_tpu_torch.physics.types import SimParams


def _box_yaw(quat: torch.Tensor) -> torch.Tensor:
    """Yaw (Z euler) of an xyzw quaternion batch (N, 4) -> (N,)."""
    x, y, z, w = quat.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _yaw_quat(yaw: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(yaw)
    return torch.stack([zero, zero, torch.sin(yaw / 2), torch.cos(yaw / 2)], dim=-1)


def _uniform(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(*shape, generator=gen, device=gen.device)


def _random_hand_pose(task, gen: torch.Generator, n: int, default_dof_pos) -> torch.Tensor:
    """The default pose with the base translated and rotated uniformly within
    the task's ranges and the 20 finger joints drawn in [0, finger_range]."""
    dof = default_dof_pos.to(gen.device)[None].repeat(n, 1)
    dof[:, 0:3] = (_uniform(gen, n, 3) * 2 - 1) * task.hand_translation_range
    dof[:, 3:6] = (_uniform(gen, n, 3) * 2 - 1) * task.hand_rotation_range
    dof[:, 6:26] = _uniform(gen, n, 20) * task.finger_range
    return dof


class BoxReorientationTask(DexTask):
    name = "BoxReorientation"
    obs_dims = {
        "object_pos": 3, "object_quat": 4, "object_vel": 3, "object_angvel": 3,
        "object_yaw_sincos": 2, "target_yaw_sincos": 2, "yaw_error": 1, "box_drift": 1,
        "finger_to_object_distances": 5, "fingers_on_box": 5, "aligned_duration": 1,
    }
    success_criteria = ("reorient_success",)
    failure_criteria = ("box_pushed_away", "box_lifted")
    reward_terms = ("orientation_tracking", "orientation_delta", "fingerpad_proximity",
                    "position_stability", "finger_contact", "alignment_hold")

    def __init__(self, task_cfg: Dict[str, Any]):
        super().__init__(task_cfg)
        c = task_cfg
        box = c.get("box", {})
        self.box_size = float(box.get("size", 0.05))
        self.box_mass = float(box.get("mass", 0.1))
        self.box_friction = float(box.get("friction", 1.0))
        self.box_xy_range = float(box.get("initial_position", {}).get("xy_range", 0.02))
        self.box_z = float(box.get("initial_position", {}).get("z", 0.027))
        self.yaw_symmetry = int(c.get("yaw_symmetry", 4))
        self.yaw_tolerance = float(c.get("yaw_tolerance", 0.15))
        self.min_initial_error = float(c.get("min_initial_error", 0.4))
        self.align_duration_threshold = float(c.get("align_duration_threshold", 1.0))
        self.position_drift_tolerance = float(c.get("position_drift_tolerance", 0.05))
        self.max_drift = float(c.get("max_drift", 0.15))
        self.lift_tolerance = float(c.get("lift_tolerance", 0.05))
        self.contact_binary_threshold = float(c.get("contact_binary_threshold", 0.1))
        rc = c.get("reward_calculation", {})
        self.orientation_decay = float(rc.get("orientation_decay", 3.0))
        self.proximity_decay = float(rc.get("proximity_decay", 10.0))
        self.drift_decay = float(rc.get("drift_decay", 20.0))
        self.hand_translation_range = float(c.get("hand_translation_range", 0.05))
        self.hand_rotation_range = float(c.get("hand_rotation_range", 0.2))
        self.finger_range = float(
            c.get("finger_randomization", {}).get("other_finger_range", 0.3))
        # the symmetric yaw period: a cube (symmetry 4) repeats every 90 deg
        self.period = 2.0 * math.pi / max(1, self.yaw_symmetry)

    # ------------------------------------------------------------------
    def configure_scene(self, params: SimParams) -> SimParams:
        return dataclasses.replace(params, has_box=True, box_size=self.box_size,
                                   box_mass=self.box_mass, box_friction=self.box_friction)

    def init_task_states(self, num_envs: int, device) -> Dict[str, torch.Tensor]:
        n = num_envs
        return {
            "target_yaw": torch.zeros(n, device=device),
            "initial_box_pos": torch.zeros(n, 3, device=device),
            "prev_yaw_error": torch.zeros(n, device=device),
            "aligned_duration_steps": torch.zeros(n, dtype=torch.int32, device=device),
        }

    # ------------------------------------------------------------------
    def compute_step(self, obs_dict, task_states, physics, kin, body_contact_force,
                     box_contact_force, control_dt, box2_contact_force=None) -> TaskStep:
        n = physics.q.shape[0]
        ts = dict(task_states)
        box_pos = physics.box_pos
        yaw = _box_yaw(physics.box_quat)
        err = symmetric_angle_error(yaw, ts["target_yaw"], self.period)
        abs_err = err.abs()
        drift = torch.linalg.vector_norm((box_pos - ts["initial_box_pos"])[:, :2], dim=-1)

        obs: Dict[str, torch.Tensor] = {
            "object_pos": box_pos, "object_quat": physics.box_quat,
            "object_vel": physics.box_linvel, "object_angvel": physics.box_angvel,
            "object_yaw_sincos": torch.stack([torch.sin(yaw), torch.cos(yaw)], dim=-1),
            "target_yaw_sincos": torch.stack([torch.sin(ts["target_yaw"]),
                                              torch.cos(ts["target_yaw"])], dim=-1),
            "yaw_error": err[:, None], "box_drift": drift[:, None],
        }
        pads = obs_dict["fingerpad_poses_world"].reshape(n, 5, 7)[:, :, :3]
        d_f2o = torch.linalg.vector_norm(pads - box_pos[:, None, :], dim=-1)
        obs["finger_to_object_distances"] = d_f2o
        fb = detect_finger_box_contacts(obs_dict, box_contact_force, box_pos, self.box_size,
                                        self.contact_binary_threshold)
        obs["fingers_on_box"] = fb.float()

        aligned = (abs_err < self.yaw_tolerance) & (drift < self.position_drift_tolerance)
        steps = torch.where(aligned, ts["aligned_duration_steps"] + 1,
                            torch.zeros_like(ts["aligned_duration_steps"]))
        ts["aligned_duration_steps"] = steps
        obs["aligned_duration"] = (steps.float() * control_dt)[:, None]

        threshold_steps = int(round(self.align_duration_threshold / control_dt))
        successes = {"reorient_success": steps >= threshold_steps}
        failures = {
            "box_pushed_away": drift > self.max_drift,
            "box_lifted": box_pos[:, 2] > self.box_z + self.lift_tolerance,
        }
        r: Dict[str, torch.Tensor] = {
            "orientation_tracking": torch.exp(-self.orientation_decay * abs_err),
            # dense improvement signal: previous |error| minus current |error|
            "orientation_delta": ts["prev_yaw_error"].abs() - abs_err,
            "fingerpad_proximity": torch.exp(-self.proximity_decay * d_f2o.amin(dim=1)),
            "position_stability": torch.exp(-self.drift_decay * drift),
            "finger_contact": fb.any(dim=1).float(),
            "alignment_hold": aligned.float(),
        }
        ts["prev_yaw_error"] = err
        return TaskStep(obs, ts, successes, failures, r)

    # ------------------------------------------------------------------
    def reset_task(self, gen: torch.Generator, num_envs: int, default_dof_pos,
                   difficulty=None, project: bool = True) -> TaskReset:
        """Uniform draws from `gen` (on its device): the box's xy and yaw, the
        target's offset from that yaw (at least `min_initial_error`, up to
        half the symmetry period, either sign), the hand's translation,
        rotation and fingers. No curriculum, no spawn projection
        (`difficulty` and `project` are accepted for the task API's sake)."""
        n, dev = num_envs, gen.device
        xy = (_uniform(gen, n, 2) * 2 - 1) * self.box_xy_range
        box_pos = torch.cat([xy, torch.full((n, 1), self.box_z, device=dev)], dim=-1)
        yaw = (_uniform(gen, n) * 2 - 1) * math.pi
        half = self.period / 2.0
        mag = self.min_initial_error + _uniform(gen, n) * (half - self.min_initial_error)
        sign = torch.where(_uniform(gen, n) < 0.5, -1.0, 1.0)
        target = yaw + sign * mag
        dof = _random_hand_pose(self, gen, n, default_dof_pos)
        ts = self.init_task_states(n, dev)
        ts["target_yaw"] = target
        ts["initial_box_pos"] = box_pos
        # the delta reward's baseline: the true initial error
        ts["prev_yaw_error"] = symmetric_angle_error(yaw, target, self.period)
        return TaskReset(dof_pos=dof, box_pos=box_pos, box_quat=_yaw_quat(yaw), task_states=ts)

"""InHandReorientation: turn a pinched box in mid-air to a target yaw (torch).

The port's counterpart of
`dexrobot_isaac_tpu/envs/tasks/in_hand_reorientation.py`. Episodes start
with the box already pinched between the thumb tip and the index and middle
tips, hanging at the hand's spawn height (`hand_spawn`, the env's
`initialHandPos`), so contacts are active from the first step. The policy
turns the box to a per-episode target yaw (cube-symmetric, as
BoxReorientation) without dropping it.

The grip is solved once, at build time, with numpy FK (`_solve_pinch`): the
finger flexion is bisected until the thumb-to-fingers gap matches the box
with a small penetration per side, and the box sits on the pinch axis's
midpoint with a face toward each tip.

Success: |yaw error| < `yaw_tolerance` while the box stays within
`drop_band` of its hang height, held `align_duration_threshold` seconds.
Failures: `box_dropped` (below the hang band) and `box_escaped` (farther
than `escape_distance` from the hand).

`compute_step` is the plain version of the task step that the fused CUDA
kernel (`csrc/fused_step.cu`, the `fused_step_inhand` build) carries per env.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.constants import DOF_INDEX, NUM_DOFS
from dexrobot_isaac_tpu_torch.envs.tasks.api import (
    DexTask,
    TaskReset,
    TaskStep,
    curriculum_scale,
    detect_finger_box_contacts,
    symmetric_angle_error,
)
from dexrobot_isaac_tpu_torch.envs.tasks.box_reorientation import _box_yaw
from dexrobot_isaac_tpu_torch.models.dexhand021 import HandModel, build_hand_model
from dexrobot_isaac_tpu_torch.physics.engine import _np_fk_pose
from dexrobot_isaac_tpu_torch.physics.types import SimParams


def _solve_pinch(model: HandModel, box_size: float, penetration: float):
    """Numpy build-time solve: the grip q (26,), the box centre's offset from
    the base (at the origin) and the box quaternion, such that the box sits
    pinched between the thumb tip and the index and middle tips with
    `penetration` per side."""
    # each finger's tip sphere: the farthest sphere on its distal link
    tips = []
    for f in (1, 2, 3):
        b = model.body_index(f"r_f_link{f}_4")
        idxs = np.nonzero(np.asarray(model.sphere_body) == b)[0]
        tips.append(int(idxs[np.argmax(np.linalg.norm(model.sphere_pos[idxs], axis=1))]))
    t_th, t_ix, t_md = tips
    r = np.asarray(model.sphere_radius)
    need = box_size + r[t_th] + 0.5 * (r[t_ix] + r[t_md]) - 2.0 * penetration

    def gap(flex: float):
        q = np.zeros(NUM_DOFS)
        q[DOF_INDEX["r_f_joint1_1"]] = math.pi / 3
        for j in ("1_2", "1_3", "1_4"):
            q[DOF_INDEX[f"r_f_joint{j}"]] = 0.5 * flex
        for f in (2, 3):
            for j in (2, 3, 4):
                q[DOF_INDEX[f"r_f_joint{f}_{j}"]] = flex
        pos, rot = _np_fk_pose(model, q)
        sb = np.asarray(model.sphere_body)
        sp = pos[sb] + np.einsum("bij,bj->bi", rot[sb], model.sphere_pos)
        thumb = sp[t_th]
        fingers = 0.5 * (sp[t_ix] + sp[t_md])
        return float(np.linalg.norm(fingers - thumb)), q, thumb, fingers

    # the gap is U-shaped in the flexion (the tips swing past each other):
    # scan a grid for its minimum, then bisect the descending branch
    grid = np.arange(0.4, 1.6001, 0.025)
    gaps = np.array([gap(x)[0] for x in grid])
    i_min = int(np.argmin(gaps))
    if gaps[i_min] > need:
        # the closest approach falls short of the penetration asked for:
        # accept a slightly shallower pinch within the tolerance below
        g, q, thumb, fingers = gap(float(grid[i_min]))
    else:
        lo, hi = 0.4, float(grid[i_min])
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if gap(mid)[0] > need:
                lo = mid
            else:
                hi = mid
        g, q, thumb, fingers = gap(0.5 * (lo + hi))
    if abs(g - need) > 0.004:
        raise ValueError(f"pinch solve failed: gap {g * 1000:.1f}mm vs need {need * 1000:.1f}mm "
                         f"(box_size={box_size})")
    d = fingers - thumb
    d_hat = d / np.linalg.norm(d)
    center = 0.5 * (thumb + fingers)
    # the quaternion that turns +x onto the pinch axis: a box face meets each tip
    ex = np.array([1.0, 0.0, 0.0])
    axis = np.cross(ex, d_hat)
    s = np.linalg.norm(axis)
    cth = float(np.dot(ex, d_hat))
    if s < 1e-8:
        bq = np.array([0.0, 0.0, 0.0, 1.0])
    else:
        th = math.atan2(s, cth)
        bq = np.concatenate([axis / s * math.sin(th / 2.0), [math.cos(th / 2.0)]])
    return q.astype(np.float32), center.astype(np.float32), bq.astype(np.float32)


class InHandReorientationTask(DexTask):
    name = "InHandReorientation"
    obs_dims = {
        "object_pos": 3, "object_quat": 4, "object_vel": 3, "object_angvel": 3,
        "object_yaw_sincos": 2, "target_yaw_sincos": 2, "yaw_error": 1, "object_rel_hand": 3,
        "finger_to_object_distances": 5, "fingers_on_box": 5, "grasp_state": 1,
        "aligned_duration": 1,
    }
    success_criteria = ("reorient_success",)
    failure_criteria = ("box_dropped", "box_escaped")
    reward_terms = ("orientation_tracking", "orientation_delta", "grasp_maintenance",
                    "height_keep", "alignment_hold")

    def __init__(self, task_cfg: Dict[str, Any]):
        super().__init__(task_cfg)
        c = task_cfg
        box = c.get("box", {})
        self.box_size = float(box.get("size", 0.05))
        self.box_mass = float(box.get("mass", 0.1))
        self.box_friction = float(box.get("friction", 1.0))
        self.hand_spawn = np.asarray(c.get("hand_spawn", [0.0, 0.0, 0.25]), dtype=np.float32)
        self.penetration = float(c.get("grip_penetration", 0.0015))
        self.yaw_symmetry = int(c.get("yaw_symmetry", 4))
        self.yaw_tolerance = float(c.get("yaw_tolerance", 0.15))
        self.min_initial_error = float(c.get("min_initial_error", 0.3))
        self.align_duration_threshold = float(c.get("align_duration_threshold", 1.0))
        self.drop_band = float(c.get("drop_band", 0.1))  # below the hang height
        self.escape_distance = float(c.get("escape_distance", 0.35))
        self.contact_binary_threshold = float(c.get("contact_binary_threshold", 0.1))
        rc = c.get("reward_calculation", {})
        self.orientation_decay = float(rc.get("orientation_decay", 3.0))
        self.height_decay = float(rc.get("height_decay", 20.0))
        cur = c.get("curriculum", {}) or {}
        self.curriculum_enabled = bool(cur.get("enabled", False))
        self.curriculum_min_fraction = float(cur.get("min_range_fraction", 0.3))
        self.period = 2.0 * math.pi / max(1, self.yaw_symmetry)
        # the build-time pinch geometry (numpy FK, the base at the origin)
        grip_q, center_off, box_quat0 = _solve_pinch(build_hand_model(), self.box_size,
                                                     self.penetration)
        self.grip_q = grip_q
        self.box_center0 = self.hand_spawn + center_off
        self.box_quat0 = box_quat0
        self.hang_z = float(self.box_center0[2])

    # ------------------------------------------------------------------
    def configure_scene(self, params: SimParams) -> SimParams:
        return dataclasses.replace(params, has_box=True, box_size=self.box_size,
                                   box_mass=self.box_mass, box_friction=self.box_friction)

    def init_task_states(self, num_envs: int, device) -> Dict[str, torch.Tensor]:
        n = num_envs
        return {
            "target_yaw": torch.zeros(n, device=device),
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
        hand_pos = obs_dict["hand_pose"][:, :3]
        hand_dist = torch.linalg.vector_norm(box_pos - hand_pos, dim=-1)
        height_err = (box_pos[:, 2] - self.hang_z).abs()

        obs: Dict[str, torch.Tensor] = {
            "object_pos": box_pos, "object_quat": physics.box_quat,
            "object_vel": physics.box_linvel, "object_angvel": physics.box_angvel,
            "object_yaw_sincos": torch.stack([torch.sin(yaw), torch.cos(yaw)], dim=-1),
            "target_yaw_sincos": torch.stack([torch.sin(ts["target_yaw"]),
                                              torch.cos(ts["target_yaw"])], dim=-1),
            "yaw_error": err[:, None], "object_rel_hand": box_pos - hand_pos,
        }
        pads = obs_dict["fingerpad_poses_world"].reshape(n, 5, 7)[:, :, :3]
        obs["finger_to_object_distances"] = torch.linalg.vector_norm(
            pads - box_pos[:, None, :], dim=-1)
        fb = detect_finger_box_contacts(obs_dict, box_contact_force, box_pos, self.box_size,
                                        self.contact_binary_threshold)
        grasped = fb[:, 0] & fb[:, 1:].any(dim=1)  # the thumb and any other finger
        obs["fingers_on_box"] = fb.float()
        obs["grasp_state"] = grasped.float()[:, None]

        aligned = (abs_err < self.yaw_tolerance) & (height_err < self.drop_band)
        steps = torch.where(aligned, ts["aligned_duration_steps"] + 1,
                            torch.zeros_like(ts["aligned_duration_steps"]))
        ts["aligned_duration_steps"] = steps
        obs["aligned_duration"] = (steps.float() * control_dt)[:, None]

        threshold_steps = int(round(self.align_duration_threshold / control_dt))
        successes = {"reorient_success": steps >= threshold_steps}
        failures = {
            "box_dropped": box_pos[:, 2] < self.hang_z - self.drop_band,
            "box_escaped": hand_dist > self.escape_distance,
        }
        r: Dict[str, torch.Tensor] = {
            "orientation_tracking": torch.exp(-self.orientation_decay * abs_err),
            "orientation_delta": ts["prev_yaw_error"].abs() - abs_err,
            "grasp_maintenance": grasped.float(),
            "height_keep": torch.exp(-self.height_decay * height_err),
            "alignment_hold": aligned.float(),
        }
        ts["prev_yaw_error"] = err
        return TaskStep(obs, ts, successes, failures, r)

    # ------------------------------------------------------------------
    def reset_task(self, gen: torch.Generator, num_envs: int, default_dof_pos,
                   difficulty=None, project: bool = True) -> TaskReset:
        """The pinch grip and the hanging box for every env; the target's
        offset from the box's yaw drawn from `gen` (at least
        `min_initial_error`, up to half the symmetry period, either sign,
        scaled by the curriculum when it is on). No spawn projection."""
        n, dev = num_envs, gen.device
        rep = lambda a: torch.as_tensor(a, device=dev)[None].repeat(n, 1)
        dof, box_pos, box_quat = rep(self.grip_q), rep(self.box_center0), rep(self.box_quat0)
        if difficulty is not None:
            difficulty = torch.as_tensor(difficulty, dtype=torch.float32, device=dev)
        cscale = curriculum_scale(difficulty, self.curriculum_min_fraction,
                                  self.curriculum_enabled)
        half = self.period / 2.0
        u = lambda: torch.rand(n, generator=gen, device=dev)
        mag = (self.min_initial_error + u() * (half - self.min_initial_error)) * cscale
        sign = torch.where(u() < 0.5, -1.0, 1.0)
        yaw0 = _box_yaw(box_quat)
        target = yaw0 + sign * mag
        ts = self.init_task_states(n, dev)
        ts["target_yaw"] = target
        ts["prev_yaw_error"] = symmetric_angle_error(yaw0, target, self.period)
        return TaskReset(dof_pos=dof, box_pos=box_pos, box_quat=box_quat, task_states=ts)

"""BlindGrasping: tactile-only box grasping with a 3-stage curriculum (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/tasks/blind_grasping.py`:
task observations, the stage FSM (1 -> 2 after stage1_duration, 2 -> 3 on
sustained contact or timeout), failure/success criteria, the stage-masked
rewards, and `reset_task` with the spawn-validity projection (lift ARTz so
the lowest fingertip clears the ground by `clearance`, through the factory's
`min_site_z` closure). The fused CUDA kernel (`csrc/fused_step.cu`) carries
the same math per env; its constants come from this object.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from benchmark.reference.plain.constants import DOF_INDEX
from benchmark.reference.plain.envs.tasks.api import (
    DexTask,
    TaskReset,
    TaskStep,
    curriculum_scale,
    detect_finger_box_contacts,
)
from benchmark.reference.plain.physics.types import SimParams

THUMB_ROT_FINGER_INDEX = DOF_INDEX["r_f_joint1_1"] - 6


def _get(cfg, key, default):
    v = cfg
    for k in key.split("."):
        if not isinstance(v, dict) or k not in v:
            return default
        v = v[k]
    return v


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


class BlindGraspingTask(DexTask):
    name = "BlindGrasping"
    obs_dims = {
        "object_pos": 3, "object_vel": 3, "finger_to_object_distances": 5,
        "avg_finger_to_object_distance": 1, "finger_to_object_height_diff": 5,
        "avg_finger_to_object_height_diff": 1, "hand_to_object_distance": 1,
        "fingerpad_distances": 10, "first_three_fingerpad_centroid": 3,
        "thumb_contact": 1, "other_fingers_contact": 1, "grasp_state": 1,
        "grasp_duration": 1, "current_stage": 1, "time_in_stage": 1,
        "stage_progress": 1,
    }
    success_criteria = ("grasp_lift_success",)
    failure_criteria = ("box_too_far", "stage1_pregrasp_failed",
                        "stage2_contact_failed", "stage3_grasp_lost")
    reward_terms = (
        "s1_height_alignment", "s1_centroid_positioning", "s1_object_stability",
        "s1_finger_height_consistency", "s1_thumb_rotation", "s2_thumb_contact",
        "s2_other_fingers_contact", "s2_grasp_achievement", "s2_fingerpad_proximity",
        "s2_base_stability", "s3_object_height", "s3_grasp_maintenance",
        "s3_grasp_duration", "s1_completion", "s2_completion", "penetration_penalty",
        "under_box_penalty",
    )

    def __init__(self, task_cfg: Dict[str, Any]):
        super().__init__(task_cfg)
        c = task_cfg
        box = c.get("box", {})
        self.box_size = float(box.get("size", 0.05))
        self.box_mass = float(box.get("mass", 0.1))
        self.box_friction = float(box.get("friction", 1.0))
        self.box_xy_range = float(_get(box, "initial_position.xy_range", 0.02))
        self.box_z = float(_get(box, "initial_position.z", 0.027))
        self.height_threshold = float(c.get("success_height_threshold", 0.2))
        self.contact_duration_threshold = float(c.get("contact_duration_threshold", 2.0))
        self.min_fingers_for_grasp = int(c.get("min_fingers_for_grasp", 2))
        self.max_box_distance = float(c.get("max_box_distance", 0.8))
        self.contact_binary_threshold = float(c.get("contact_binary_threshold", 0.1))
        self.stage1_duration = float(c.get("stage1_duration", 4.0))
        self.stage2_duration = float(c.get("stage2_duration", 3.0))
        self.stage2_contact_success_threshold = float(
            _get(c, "stage_evaluation.stage2_contact_success_threshold", 0.5))
        self.hand_translation_range = float(c.get("hand_translation_range", 0.2))
        self.hand_rotation_range = float(c.get("hand_rotation_range", 0.785))
        self.thumb_rotation_range = float(
            _get(c, "finger_randomization.thumb_rotation_range", 1.571))
        self.other_finger_range = float(
            _get(c, "finger_randomization.other_finger_range", 0.524))
        rc = c.get("reward_calculation", {})
        self.height_alignment_decay = float(rc.get("height_alignment_decay", 5.0))
        self.centroid_positioning_decay = float(rc.get("centroid_positioning_decay", 5.0))
        self.object_stability_decay = float(rc.get("object_stability_decay", 100.0))
        self.first_three_height_consistency_decay = float(
            rc.get("first_three_height_consistency_decay", 50.0))
        self.fingerpad_proximity_decay = float(rc.get("fingerpad_proximity_decay", 10.0))
        self.base_stability_decay = float(rc.get("base_stability_decay", 3.0))
        qt = c.get("quality_thresholds", {})
        self.height_tolerance = float(qt.get("height_tolerance", 0.03))
        self.centroid_tolerance = float(qt.get("centroid_tolerance", 0.08))
        self.position_drift_tolerance = float(qt.get("position_drift_tolerance", 0.01))
        self.velocity_tolerance = float(qt.get("velocity_tolerance", 0.005))
        cur = c.get("curriculum", {}) or {}
        self.curriculum_enabled = bool(cur.get("enabled", False))
        self.curriculum_min_fraction = float(cur.get("min_range_fraction", 0.2))
        sp = c.get("spawn_projection", {}) or {}
        self.spawn_projection = bool(sp.get("enabled", True))
        self.spawn_projection_clearance = float(sp.get("clearance", 0.01))
        self._min_tip_z_fn = None  # attached by the factory
        pp = c.get("penetration_prevention", {})
        self.geometric_penetration_factor = float(pp.get("geometricPenetrationFactor", 1.0))
        self.proximity_min_distance_factor = float(pp.get("proximityMinDistanceFactor", 1.0))
        self.penetration_depth_scale = float(pp.get("penetrationDepthScale", 100.0))
        cs = c.get("clearance_shaping", {}) or {}
        self.under_box_margin = float(cs.get("under_margin", 0.01))
        self.under_box_footprint_factor = float(cs.get("footprint_factor", 1.4))
        self.under_box_ground_z = float(cs.get("box_near_ground_z", 0.10))

    def configure_scene(self, params: SimParams) -> SimParams:
        import dataclasses

        return dataclasses.replace(params, has_box=True, box_size=self.box_size,
                                   box_mass=self.box_mass, box_friction=self.box_friction)

    def init_task_states(self, num_envs: int, device) -> Dict[str, torch.Tensor]:
        n = num_envs
        z = lambda dt: torch.zeros(n, dtype=dt, device=device)
        return {
            "success_duration_steps": z(torch.int32),
            "success_conditions_met": z(torch.bool),
            "current_stage": torch.ones(n, dtype=torch.int32, device=device),
            "time_in_stage": z(torch.float32),
            "stage_contact_duration": z(torch.float32),
            "just_transitioned_to_stage2": z(torch.bool),
            "just_transitioned_to_stage3": z(torch.bool),
            "initial_box_pos": torch.zeros(n, 3, device=device),
        }

    # ------------------------------------------------------------------
    def compute_step(self, obs_dict, task_states, physics, kin, body_contact_force,
                     box_contact_force, control_dt) -> TaskStep:
        n = physics.q.shape[0]
        ts = dict(task_states)
        box_pos, box_vel = physics.box_pos, physics.box_linvel
        obs: Dict[str, torch.Tensor] = {"object_pos": box_pos, "object_vel": box_vel}
        pads = obs_dict["fingerpad_poses_world"].reshape(n, 5, 7)[:, :, :3]
        d_f2o = _norm(pads - box_pos[:, None, :])
        obs["finger_to_object_distances"] = d_f2o
        obs["avg_finger_to_object_distance"] = d_f2o.mean(dim=1)
        hdiff = (pads[:, :, 2] - box_pos[:, None, 2]).abs()
        obs["finger_to_object_height_diff"] = hdiff
        obs["avg_finger_to_object_height_diff"] = hdiff.mean(dim=1)
        obs["hand_to_object_distance"] = _norm(obs_dict["hand_pose"][:, :3] - box_pos)
        iu, ju = torch.triu_indices(5, 5, offset=1, device=pads.device)
        obs["fingerpad_distances"] = _norm(pads[:, iu] - pads[:, ju])
        obs["first_three_fingerpad_centroid"] = pads[:, :3].mean(dim=1)

        fb = detect_finger_box_contacts(obs_dict, box_contact_force, box_pos,
                                        self.box_size, self.contact_binary_threshold)
        thumb_contact = fb[:, 0]
        other_contact = fb[:, 1:].any(dim=1)
        grasp_state = thumb_contact & other_contact
        obs["thumb_contact"] = thumb_contact.float()[:, None]
        obs["other_fingers_contact"] = other_contact.float()[:, None]
        obs["grasp_state"] = grasp_state.float()[:, None]

        num_on_box = fb.sum(dim=1)
        cond = (box_pos[:, 2] > self.height_threshold) & (num_on_box >= self.min_fingers_for_grasp)
        steps = torch.where(cond, ts["success_duration_steps"] + 1,
                            torch.zeros_like(ts["success_duration_steps"]))
        ts["success_duration_steps"] = steps
        ts["success_conditions_met"] = cond
        obs["grasp_duration"] = (steps.float() * control_dt)[:, None]

        stage = ts["current_stage"]
        tis = ts["time_in_stage"] + control_dt
        fc = obs_dict["contact_binary"] > 0.5
        thumb_and_other = fc[:, 0] & fc[:, 1:].any(dim=1)
        in_s2 = stage == 2
        scd_old = ts["stage_contact_duration"]
        scd = torch.where(in_s2, torch.where(thumb_and_other, scd_old + control_dt,
                                             torch.zeros_like(scd_old)), scd_old)
        s1_complete = (stage == 1) & (tis >= self.stage1_duration)
        s2_complete = (in_s2 & (scd >= self.stage2_contact_success_threshold)) | (
            in_s2 & (tis >= self.stage2_duration))
        stage = torch.where(s1_complete, torch.full_like(stage, 2), stage)
        stage = torch.where(s2_complete, torch.full_like(stage, 3), stage)
        moved = s1_complete | s2_complete
        tis = torch.where(moved, torch.zeros_like(tis), tis)
        scd = torch.where(moved, torch.zeros_like(scd), scd)
        ts["current_stage"] = stage
        ts["time_in_stage"] = tis
        ts["stage_contact_duration"] = scd
        ts["just_transitioned_to_stage2"] = s1_complete
        ts["just_transitioned_to_stage3"] = s2_complete
        obs["current_stage"] = stage.float()[:, None]
        obs["time_in_stage"] = tis[:, None]
        one = torch.ones_like(tis)
        progress = torch.where(
            stage == 1, torch.clamp(tis / self.stage1_duration, 0.0, 1.0),
            torch.where(stage == 2, torch.clamp(tis / self.stage2_duration, 0.0, 1.0), one))
        obs["stage_progress"] = progress[:, None]

        centroid = obs["first_three_fingerpad_centroid"]
        drift = _norm(box_pos - ts["initial_box_pos"])
        pregrasp_ok = (
            (hdiff[:, :3] <= self.height_tolerance).all(dim=1)
            & (_norm(centroid - box_pos) <= self.centroid_tolerance)
            & (drift <= self.position_drift_tolerance)
            & (_norm(box_vel) <= self.velocity_tolerance)
        )
        failures = {
            "box_too_far": obs["hand_to_object_distance"] > self.max_box_distance,
            "stage1_pregrasp_failed": s1_complete & ~pregrasp_ok,
            "stage2_contact_failed": s2_complete & ~grasp_state,
            "stage3_grasp_lost": (stage == 3) & ~grasp_state,
        }
        threshold_steps = int(round(self.contact_duration_threshold / control_dt))
        successes = {"grasp_lift_success": steps >= threshold_steps}

        # stage-masked rewards
        s1, s2, s3 = ((stage == k).float() for k in (1, 2, 3))
        r: Dict[str, torch.Tensor] = {}
        r["s1_height_alignment"] = torch.exp(
            -self.height_alignment_decay * obs["avg_finger_to_object_height_diff"]) * s1
        r["s1_centroid_positioning"] = torch.exp(
            -self.centroid_positioning_decay * _norm(centroid - box_pos)) * s1
        r["s1_object_stability"] = torch.exp(
            -self.object_stability_decay * (drift + _norm(box_vel))) * s1
        hvar = torch.var(pads[:, :3, 2], dim=1, unbiased=True)
        r["s1_finger_height_consistency"] = torch.exp(
            -self.first_three_height_consistency_decay * hvar) * s1
        thumb_rot = obs_dict["all_finger_dof_pos"][:, THUMB_ROT_FINGER_INDEX]
        r["s1_thumb_rotation"] = torch.exp(-5.0 * (thumb_rot - math.pi / 2).abs()) * s1
        r["s2_thumb_contact"] = thumb_contact.float() * s2
        r["s2_other_fingers_contact"] = other_contact.float() * s2
        r["s2_grasp_achievement"] = grasp_state.float() * s2
        tips = obs_dict["fingertip_poses_world"].reshape(n, 5, 7)[:, :, :3]
        min_dist = _norm(tips - box_pos[:, None, :]).amin(dim=1)
        safe_dist = torch.clamp(min_dist, min=self.box_size / 2.0 * self.proximity_min_distance_factor)
        r["s2_fingerpad_proximity"] = torch.exp(-self.fingerpad_proximity_decay * safe_dist) * s2
        r["s2_base_stability"] = torch.exp(
            -self.base_stability_decay * _norm(obs_dict["base_dof_vel"])) * s2
        r["s3_object_height"] = torch.clamp(
            (box_pos[:, 2] - self.box_z) / (self.height_threshold - self.box_z), 0.0, 1.0) * s3
        r["s3_grasp_maintenance"] = grasp_state.float() * s3
        r["s3_grasp_duration"] = torch.clamp(
            obs["grasp_duration"][:, 0] / self.contact_duration_threshold, 0.0, 1.0) * s3
        r["s1_completion"] = (s1_complete & ~failures["stage1_pregrasp_failed"]).float()
        r["s2_completion"] = (s2_complete & ~failures["stage2_contact_failed"]).float()
        threshold = self.box_size / 2.0 * self.geometric_penetration_factor
        r["penetration_penalty"] = torch.clamp(threshold - min_dist, min=0.0) \
            * self.penetration_depth_scale
        half = self.box_size / 2.0 * self.under_box_footprint_factor
        in_fp = ((tips[:, :, 0] - box_pos[:, None, 0]).abs() < half) & (
            (tips[:, :, 1] - box_pos[:, None, 1]).abs() < half)
        low = torch.clamp(self.under_box_margin - tips[:, :, 2], min=0.0)
        near_ground = (box_pos[:, 2] < self.under_box_ground_z).float()
        r["under_box_penalty"] = (in_fp.float() * low).sum(dim=1) * near_ground
        return TaskStep(obs, ts, successes, failures, r)

    # ------------------------------------------------------------------
    def reset_task(self, gen: torch.Generator, num_envs: int, default_dof_pos,
                   difficulty=None, project: bool = True) -> TaskReset:
        """Uniform draws from `gen` (on its device). project=False leaves the
        spawn projection to the caller (the fused kernel projects its reset
        rows with the same min_site_z)."""
        n, dev = num_envs, gen.device
        u = lambda *shape: torch.rand(*shape, generator=gen, device=dev)
        cscale = curriculum_scale(difficulty, self.curriculum_min_fraction,
                                  self.curriculum_enabled)
        xy = (u(n, 2) * 2 - 1) * self.box_xy_range
        box_pos = torch.cat([xy, torch.full((n, 1), self.box_z, device=dev)], dim=-1)
        yaw = (u(n) * 2 - 1) * math.pi
        zero = torch.zeros(n, device=dev)
        box_quat = torch.stack([zero, zero, torch.sin(yaw / 2), torch.cos(yaw / 2)], dim=-1)
        dof = default_dof_pos.to(dev)[None].repeat(n, 1)
        dof[:, 0:3] = (u(n, 3) * 2 - 1) * self.hand_translation_range * cscale
        dof[:, 3:6] = (u(n, 3) * 2 - 1) * self.hand_rotation_range * cscale
        ranges = torch.full((20,), self.other_finger_range, device=dev)
        ranges[0] = self.thumb_rotation_range
        dof[:, 6:26] = u(n, 20) * ranges
        if project:
            dof = self.project_spawn(dof)
        ts = self.init_task_states(n, dev)
        ts["initial_box_pos"] = box_pos
        return TaskReset(dof_pos=dof, box_pos=box_pos, box_quat=box_quat, task_states=ts)

    def project_spawn(self, dof):
        """Lift ARTz so the lowest fingertip clears the ground by
        `spawn_projection_clearance` (a no-op for valid spawns)."""
        if not (self.spawn_projection and self._min_tip_z_fn is not None):
            return dof
        lift = torch.clamp(self.spawn_projection_clearance - self._min_tip_z_fn(dof), min=0.0)
        dof = dof.clone()
        dof[:, 2] = dof[:, 2] + lift
        return dof

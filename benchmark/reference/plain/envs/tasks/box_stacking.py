"""BoxStacking: grasp a cube and stack it on a platform cube (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/tasks/box_stacking.py`,
the one two-body task: the pick cube is the scene's box, the platform cube
its second box (`SimParams.has_box2`). Success holds the pick cube centred
on the platform, at stacking height, nearly at rest and released, for
`hold_duration_threshold` seconds; knocking the platform away
(`platform_moved`) or losing the cube (`box_too_far`) fail the episode.

With `curriculum.enabled` the resets scale with the runtime difficulty,
optionally banded per env (`difficulty_band`, `band_top_fraction`), and the
success criterion, the platform-drift tolerance and the hitting-ground
margins (`fingertip_bridge_margin`, the per-tip `pocket_margin`) anneal from
relaxed at difficulty 0 to strict at `release_anneal_end` /
`pocket_anneal_end`. Each env carries its spawn difficulty
(`spawn_difficulty`), which also gives the fused step its
`success_strict`/`done_strict` extras.

`compute_step` is the plain version of the task step that the fused CUDA
kernel (`csrc/fused_step.cu`, the `fused_step_stacking` build) carries per
env; its constants come from this object.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict

import torch

from benchmark.reference.plain.envs.tasks.api import (
    DexTask,
    TaskReset,
    TaskStep,
    curriculum_scale,
    detect_finger_box_contacts,
)
from benchmark.reference.plain.physics.types import SimParams


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


class BoxStackingTask(DexTask):
    name = "BoxStacking"
    obs_dims = {
        "object_pos": 3, "object_quat": 4, "object_vel": 3, "platform_pos": 3,
        "platform_quat": 4, "to_stack_target": 3, "stack_dist": 1,
        "finger_to_object_distances": 5, "fingers_on_box": 5, "hold_duration": 1,
    }
    success_criteria = ("stack_success",)
    failure_criteria = ("box_too_far", "platform_moved")
    reward_terms = (
        "fingerpad_proximity", "finger_contact", "lift", "transport", "transport_delta",
        "place", "stacked_hold", "release", "under_box_penalty", "platform_drift_penalty",
    )

    def __init__(self, task_cfg: Dict[str, Any]):
        super().__init__(task_cfg)
        c = task_cfg
        box = c.get("box", {})
        self.box_size = float(box.get("size", 0.05))
        self.box_mass = float(box.get("mass", 0.1))
        self.box_friction = float(box.get("friction", 1.0))
        self.box_xy_range = float(box.get("initial_position", {}).get("xy_range", 0.02))
        self.box_z = float(box.get("initial_position", {}).get("z", 0.027))
        plat = c.get("platform", {})
        self.plat_size = float(plat.get("size", 0.08))
        self.plat_mass = float(plat.get("mass", 0.5))
        self.plat_friction = float(plat.get("friction", 1.2))
        pd = plat.get("distance", {})
        self.plat_dist_min = float(pd.get("min", 0.10))
        self.plat_dist_max = float(pd.get("max", 0.16))
        self.position_tolerance = float(c.get("position_tolerance", 0.02))
        self.height_tolerance = float(c.get("height_tolerance", 0.015))
        self.rest_speed_tolerance = float(c.get("rest_speed_tolerance", 0.1))
        self.hold_duration_threshold = float(c.get("hold_duration_threshold", 0.5))
        self.box_far_threshold = float(c.get("box_far_threshold", 0.35))
        self.platform_move_tolerance = float(c.get("platform_move_tolerance", 0.05))
        self.contact_binary_threshold = float(c.get("contact_binary_threshold", 0.1))
        rc = c.get("reward_calculation", {})
        self.proximity_decay = float(rc.get("proximity_decay", 10.0))
        self.transport_decay = float(rc.get("transport_decay", 8.0))
        self.place_decay = float(rc.get("place_decay", 20.0))
        self.hand_translation_range = float(c.get("hand_translation_range", 0.05))
        self.hand_rotation_range = float(c.get("hand_rotation_range", 0.2))
        self.finger_range = float(
            c.get("finger_randomization", {}).get("other_finger_range", 0.3))
        cur = c.get("curriculum", {})
        self.curriculum_enabled = bool(cur.get("enabled", False))
        self.curriculum_min_fraction = float(cur.get("min_fraction", 0.4))
        # a fraction of resets (annealed to 0 at difficulty 1) start with the
        # cube on the platform and the hand caging it
        self.reverse_spawn_fraction = float(cur.get("reverse_spawn_fraction", 0.0))
        # the bridge anneal: below this difficulty "stacked" tolerates
        # floor(3 (1 - d / end)) fingers on the cube, relaxes the pose
        # tolerances by up to tolerance_relax x and shortens the hold to
        # hold_anneal_min; 0 keeps the strict criterion
        self.release_anneal_end = float(cur.get("release_anneal_end", 0.0))
        self.tolerance_relax = float(cur.get("tolerance_relax", 1.0))
        self.hold_anneal_min = float(cur.get("hold_anneal_min", self.hold_duration_threshold))
        # per-env difficulty band U(d - band, d); band_top_fraction of the
        # envs spawn exactly at d (the strict promotion gate's sample)
        self.difficulty_band = float(cur.get("difficulty_band", 0.0))
        self.band_top_fraction = float(cur.get("band_top_fraction", 0.25))
        # the task's own hitting_ground (overrides the builtin when a margin
        # is set): the fingertip limit relaxes by fingertip_bridge_margin x
        # bridge everywhere and, per tip, by pocket_margin x pocket bridge
        # while the cube and that tip are within pocket_radius of the stack
        # point
        hsafe = (c.get("termination", {}) or {}).get("height_safety", {}) or {}
        self.handbase_threshold = float(hsafe.get("handbase_threshold", 0.0))
        self.fingertip_threshold = float(hsafe.get("fingertip_threshold", 0.0))
        self.fingertip_bridge_margin = float(hsafe.get("fingertip_bridge_margin", 0.0))
        self.pocket_margin = float(hsafe.get("pocket_margin", 0.0))
        self.pocket_radius = float(hsafe.get("pocket_radius", 0.05))
        self.pocket_anneal_end = float(hsafe.get("pocket_anneal_end", 1.0))
        if self.pocket_margin > 0.0 and self.pocket_anneal_end <= 0.0:
            logging.getLogger("dexhand_tpu").warning(
                "BoxStacking: pocket_margin=%g has no effect because pocket_anneal_end is 0",
                self.pocket_margin)
        cs = c.get("clearance_shaping", {}) or {}
        self.under_box_margin = float(cs.get("under_margin", 0.01))
        self.under_box_footprint_factor = float(cs.get("footprint_factor", 1.4))
        self.under_box_ground_z = float(cs.get("box_near_ground_z", 0.10))
        self.drift_free_margin = float(cs.get("drift_free_margin", 0.01))

    @property
    def overrides_hitting_ground(self) -> bool:
        return self.fingertip_bridge_margin > 0.0 or self.pocket_margin > 0.0

    # ------------------------------------------------------------------
    def configure_scene(self, params: SimParams) -> SimParams:
        return dataclasses.replace(
            params, has_box=True, box_size=self.box_size, box_mass=self.box_mass,
            box_friction=self.box_friction, has_box2=True, box2_size=self.plat_size,
            box2_mass=self.plat_mass, box2_friction=self.plat_friction)

    def init_task_states(self, num_envs: int, device) -> Dict[str, torch.Tensor]:
        n = num_envs
        return {
            "platform_spawn_xy": torch.zeros(n, 2, device=device),
            "hold_duration_steps": torch.zeros(n, dtype=torch.int32, device=device),
            "prev_transport_dist": torch.zeros(n, device=device),
            "spawn_difficulty": torch.ones(n, device=device),
        }

    def _bridge(self, spawn_difficulty, end: float):
        """1 at difficulty 0 -> 0 at `end` (all zero when end is 0)."""
        if end > 0.0:
            return torch.clamp(1.0 - spawn_difficulty / end, 0.0, 1.0)
        return torch.zeros_like(spawn_difficulty)

    # ------------------------------------------------------------------
    def compute_step(self, obs_dict, task_states, physics, kin, body_contact_force,
                     box_contact_force, control_dt, box2_contact_force=None) -> TaskStep:
        n = physics.q.shape[0]
        ts = dict(task_states)
        box_pos, box_vel, plat_pos = physics.box_pos, physics.box_linvel, physics.box2_pos
        # the stack point: centred on the platform's top face
        target = torch.cat([plat_pos[:, :2], plat_pos[:, 2:3]
                            + (self.plat_size + self.box_size) / 2.0], dim=-1)
        to_target = target - box_pos
        transport_dist = _norm(to_target)
        xy_err = _norm(to_target[:, :2])
        z_err = to_target[:, 2].abs()
        speed = _norm(box_vel)

        obs: Dict[str, torch.Tensor] = {
            "object_pos": box_pos, "object_quat": physics.box_quat, "object_vel": box_vel,
            "platform_pos": plat_pos, "platform_quat": physics.box2_quat,
            "to_stack_target": to_target, "stack_dist": transport_dist[:, None],
        }
        pads = obs_dict["fingerpad_poses_world"].reshape(n, 5, 7)[:, :, :3]
        d_f2o = _norm(pads - box_pos[:, None, :])
        obs["finger_to_object_distances"] = d_f2o
        fb = detect_finger_box_contacts(obs_dict, box_contact_force, box_pos, self.box_size,
                                        self.contact_binary_threshold)
        obs["fingers_on_box"] = fb.float()
        n_on_i = fb.sum(dim=1)

        # stacked: at the pose, at rest, released (up to `allowed` fingers)
        bridge = self._bridge(ts["spawn_difficulty"], self.release_anneal_end)
        relax = 1.0 + (self.tolerance_relax - 1.0) * bridge
        at_pose = (xy_err < self.position_tolerance * relax) & (
            z_err < self.height_tolerance * relax)
        allowed = torch.floor(3.0 * bridge + 1e-6).to(torch.int32)
        stacked = at_pose & (speed < self.rest_speed_tolerance) & (n_on_i <= allowed)
        steps = torch.where(stacked, ts["hold_duration_steps"] + 1,
                            torch.zeros_like(ts["hold_duration_steps"]))
        ts["hold_duration_steps"] = steps
        obs["hold_duration"] = (steps.float() * control_dt)[:, None]

        hold_secs = self.hold_duration_threshold - (
            self.hold_duration_threshold - self.hold_anneal_min) * bridge
        threshold_steps = torch.round(hold_secs / control_dt).to(torch.int32)
        successes = {"stack_success": steps >= threshold_steps}
        plat_moved = _norm(plat_pos[:, :2] - ts["platform_spawn_xy"])
        failures = {
            "box_too_far": _norm(box_pos[:, :2]) > self.box_far_threshold,
            "platform_moved": plat_moved > self.platform_move_tolerance * relax,
        }
        tips3 = obs_dict["fingertip_poses_world"].reshape(n, 5, 7)[:, :, :3]
        if self.overrides_hitting_ground:
            tip_pocket = (transport_dist < self.pocket_radius)[:, None] & (
                _norm(tips3[:, :, :2] - target[:, None, :2]) < self.pocket_radius)
            pocket_bridge = self._bridge(ts["spawn_difficulty"], self.pocket_anneal_end)
            margin = self.fingertip_bridge_margin * bridge[:, None] + torch.where(
                tip_pocket, self.pocket_margin * pocket_bridge[:, None],
                torch.zeros_like(tips3[:, :, 2]))
            failures["hitting_ground"] = (
                (obs_dict["hand_pose"][:, 2] < self.handbase_threshold)
                | (tips3[:, :, 2] < self.fingertip_threshold - margin).any(dim=1))

        r: Dict[str, torch.Tensor] = {}
        r["fingerpad_proximity"] = torch.exp(-self.proximity_decay * d_f2o.amin(dim=1))
        n_on = n_on_i.float()
        r["finger_contact"] = torch.clamp(n_on, max=3.0) / 3.0
        held = (n_on >= 2) & (box_pos[:, 2] > self.box_z + 0.02)
        carrying = held & ~at_pose
        r["lift"] = carrying.float()
        r["transport"] = carrying.float() * torch.exp(-self.transport_decay * transport_dist)
        r["transport_delta"] = ts["prev_transport_dist"] - transport_dist
        r["place"] = torch.exp(-self.place_decay * (xy_err + z_err))
        r["stacked_hold"] = stacked.float()
        r["release"] = at_pose.float() * (1.0 - torch.clamp(n_on, max=3.0) / 3.0)
        half = self.box_size / 2.0 * self.under_box_footprint_factor
        in_fp = ((tips3[:, :, 0] - box_pos[:, None, 0]).abs() < half) & (
            (tips3[:, :, 1] - box_pos[:, None, 1]).abs() < half)
        low = torch.clamp(self.under_box_margin - tips3[:, :, 2], min=0.0)
        near_ground = (box_pos[:, 2] < self.under_box_ground_z).float()
        r["under_box_penalty"] = (in_fp.float() * low).sum(dim=1) * near_ground
        r["platform_drift_penalty"] = torch.clamp(
            plat_moved - self.drift_free_margin, min=0.0) * (1.0 - bridge)
        ts["prev_transport_dist"] = transport_dist
        return TaskStep(obs, ts, successes, failures, r)

    # ------------------------------------------------------------------
    def reset_task(self, gen: torch.Generator, num_envs: int, default_dof_pos,
                   difficulty=None, project: bool = True) -> TaskReset:
        """Uniform draws from `gen` (on its device): the difficulty band, the
        pick cube's xy and yaw, the platform's direction, distance and yaw,
        the hand's translation, rotation and fingers, and the reverse spawn's
        choice, jitter and fingers. No spawn projection (`project` is
        accepted for the task API's sake)."""
        n, dev = num_envs, gen.device
        u = lambda *shape: torch.rand(*shape, generator=gen, device=dev)
        if difficulty is not None:
            difficulty = torch.as_tensor(difficulty, dtype=torch.float32, device=dev)
        if self.curriculum_enabled and difficulty is not None and self.difficulty_band > 0.0:
            band = (difficulty < 1.0).float() * self.difficulty_band  # none at 1.0
            banded = torch.clamp(difficulty - u(n) * band, 0.0, 1.0)
            at_top = u(n) < self.band_top_fraction
            difficulty = torch.where(at_top, difficulty.expand(n), banded)
        scale = curriculum_scale(difficulty, self.curriculum_min_fraction,
                                 self.curriculum_enabled)
        scale_col = scale[:, None] if getattr(scale, "ndim", 0) == 1 else scale

        zero = torch.zeros(n, device=dev)
        yaw_quat = lambda a: torch.stack([zero, zero, torch.sin(a / 2), torch.cos(a / 2)], -1)
        xy = (u(n, 2) * 2 - 1) * self.box_xy_range
        box_pos = torch.cat([xy, torch.full((n, 1), self.box_z, device=dev)], dim=-1)
        box_quat = yaw_quat((u(n) * 2 - 1) * math.pi * scale)
        theta = u(n) * 2.0 * math.pi
        mag = self.plat_dist_min + (u(n) * (self.plat_dist_max - self.plat_dist_min)) * scale
        plat_xy = torch.stack([mag * torch.cos(theta), mag * torch.sin(theta)], dim=-1)
        box2_pos = torch.cat([plat_xy, torch.full((n, 1), self.plat_size / 2.0, device=dev)],
                             dim=-1)
        box2_quat = yaw_quat((u(n) * 2 - 1) * math.pi)
        dof = default_dof_pos.to(dev)[None].repeat(n, 1)
        dof[:, 0:3] = (u(n, 3) * 2 - 1) * self.hand_translation_range * scale_col
        dof[:, 3:6] = (u(n, 3) * 2 - 1) * self.hand_rotation_range * scale_col
        dof[:, 6:26] = u(n, 20) * self.finger_range * scale_col

        if self.curriculum_enabled:
            # reverse spawn: the cube on the platform top, the hand caging it
            d = difficulty if difficulty is not None else torch.ones((), device=dev)
            rev = (u(n) < self.reverse_spawn_fraction * (1.0 - d))[:, None]
            jit_xy = (u(n, 2) * 2 - 1) * 0.005
            rev_box_pos = torch.cat([plat_xy + jit_xy, torch.full(
                (n, 1), self.plat_size + self.box_size / 2.0 - 0.0008, device=dev)], dim=-1)
            box_pos = torch.where(rev, rev_box_pos, box_pos)
            box_quat = torch.where(rev, torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev), box_quat)
            stack_z = self.plat_size + self.box_size / 2.0
            rev_dof = torch.zeros_like(dof)
            rev_dof[:, 0] = plat_xy[:, 0] - 0.177
            rev_dof[:, 1] = plat_xy[:, 1] - 0.017
            rev_dof[:, 2] = stack_z - 0.19
            rev_dof[:, 6:26] = 0.35 + (u(n, 20) * 2 - 1) * 0.05
            dof = torch.where(rev, rev_dof, dof)

        ts = self.init_task_states(n, dev)
        ts["platform_spawn_xy"] = plat_xy
        ts["spawn_difficulty"] = (difficulty if difficulty is not None
                                  else torch.ones((), device=dev)).expand(n).clone()
        stack_pt = box2_pos.clone()
        stack_pt[:, 2] += (self.plat_size + self.box_size) / 2.0
        ts["prev_transport_dist"] = _norm(stack_pt - box_pos)
        return TaskReset(dof_pos=dof, box_pos=box_pos, box_quat=box_quat, task_states=ts,
                         box2_pos=box2_pos, box2_quat=box2_quat)

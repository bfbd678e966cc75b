"""K1: the fused env step, the WHOLE control step in one CUDA kernel.

The port of `dexrobot_isaac_tpu/envs/fused_step.py`. The kernel
(`csrc/fused_step.cu`, a half-warp per env over the lane physics of
`csrc/lane_physics.cuh`) runs the action pipeline, `physics_steps_per_control
x substeps` substeps and the final FK, the default observations, the task's
step, termination, rewards, the spawn projection of the reset rows and the
done-masked reset merge, over a packed transposed state. Each task has its
own build (`FUSED_BUILDS`): BlindGrasping, BaseTask (no task step),
BoxStacking (with the platform cube's rows), BoxReorientation,
InHandReorientation and BoxPushing.

- `FusedEnvState` holds `rows_f (Rf, N) f32` and `rows_i (Ri, N) i32` (env
  index minor, as in the JAX package), the write-only `rows_c`, and the
  scalar consecutive-successes and difficulty. `FusedLayout` packs and
  unpacks an `EnvState`; `prev_dof_pos` (== q) and `active_rule_targets`
  (== active_prev_targets under the default pre-action rule) are not stored.
- The kernel writes the next rows_f/rows_i INTO the same tensors, in place,
  as the JAX kernel aliases them (`input_output_aliases={0: 0, 1: 1}`):
  each thread reads its env's whole column before it writes any of it.
- Reset samples and DR scales are kernel operands (`rst_T`, `drn_T`), drawn
  every step from the env's torch.Generator unprojected; the kernel projects
  the reset poses with the same `min_site_z` as the factory's reset path.

`build_fused_step` makes the wrapper (`kernel`): it launches the kernel on
CUDA tensors and runs the plain version (`kernel_plain`: unpack -> the env's
plain step -> pack) on CPU tensors. Configurations without a kernel
implementation, or whose rows do not fit the build's staging in shared
memory, raise `FusedUnsupported` when the fused step is made. Tasks that
carry each env's spawn difficulty (BoxStacking) also get
`success_strict`/`done_strict` extras, as the unfused step does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.constants import NUM_DOFS
from dexrobot_isaac_tpu_torch.envs import action as action_mod
from dexrobot_isaac_tpu_torch.envs.rewards import COMMON_TERMS
from dexrobot_isaac_tpu_torch.envs.observations import default_obs_dims
from dexrobot_isaac_tpu_torch.envs.tasks.api import TaskReset
from dexrobot_isaac_tpu_torch.envs.tasks.base_task import BaseTask
from dexrobot_isaac_tpu_torch.envs.tasks.blind_grasping import BlindGraspingTask
from dexrobot_isaac_tpu_torch.envs.tasks.box_pushing import BoxPushingTask
from dexrobot_isaac_tpu_torch.envs.tasks.box_reorientation import BoxReorientationTask
from dexrobot_isaac_tpu_torch.envs.tasks.box_stacking import BoxStackingTask
from dexrobot_isaac_tpu_torch.envs.tasks.in_hand_reorientation import InHandReorientationTask
from dexrobot_isaac_tpu_torch.envs.types import EnvState
from dexrobot_isaac_tpu_torch.physics import lane_step
from dexrobot_isaac_tpu_torch.physics.types import BOX2_FIELDS, DR_FIELDS, DRSample, PhysicsState
from dexrobot_isaac_tpu_torch.utils import kernel_build as kb


class FusedUnsupported(RuntimeError):
    """This env configuration has no fused-kernel implementation."""


@dataclasses.dataclass
class FusedEnvState:
    rows_f: torch.Tensor                 # (Rf, N) float32, read+write (in place)
    rows_i: torch.Tensor                 # (Ri, N) int32, read+write (in place)
    rows_c: torch.Tensor                 # (Rc, N) float32, write-only
    consecutive_successes: torch.Tensor  # () int32
    difficulty: torch.Tensor             # () float32


class FusedLayout:
    """Static row layout from an EnvState template: leaves flattened to (N,
    k) and stacked as k rows; float32 leaves in the f32 pack, int32/bool in
    the i32 pack, the write-only leaves in the cold pack."""

    _F_DIRECT = ["active_prev_targets", "prev_actions", "prev_contact_binary",
                 "prev_finger_dof_vel", "prev_hand_vel", "prev_hand_ang_vel"]
    _F_COLD = ["full_dof_targets", "body_contact_force"]
    _I_DIRECT = ["episode_step_count", "contact_duration_steps", "prev_contacts"]
    _PHYS = ["q", "qd", "box_pos", "box_quat", "box_linvel", "box_angvel"]

    def __init__(self, template: EnvState):
        # a two-box scene: the second box's 13 rows join the f32 pack
        self.has_box2 = template.physics.box2_pos is not None
        self.phys_names = self._PHYS + (list(BOX2_FIELDS) if self.has_box2 else [])
        self.shapes: Dict[str, tuple] = {}
        self.dtypes: Dict[str, torch.dtype] = {}
        f_names, i_names, c_names = [], [], []

        def add(name, leaf, cold=False):
            self.shapes[name] = tuple(leaf.shape)
            self.dtypes[name] = leaf.dtype
            if cold:
                c_names.append(name)
            else:
                (f_names if leaf.dtype == torch.float32 else i_names).append(name)

        for n in self.phys_names:
            add(n, getattr(template.physics, n))
        for n in self._F_DIRECT:
            add(n, getattr(template, n))
        for n in self._F_COLD:
            add(n, getattr(template, n), cold=True)
        for n in self._I_DIRECT:
            add(n, getattr(template, n))
        for k in DR_FIELDS:
            add(f"dr.{k}", getattr(template.dr, k))
        for k in sorted(template.success_flags):
            add(f"sf.{k}", template.success_flags[k])
        for k in sorted(template.failure_flags):
            add(f"ff.{k}", template.failure_flags[k])
        for k in sorted(template.task_states):
            add(f"ts.{k}", template.task_states[k])

        def offsets(names):
            offs, total = {}, 0
            for n in names:
                size = int(np.prod(self.shapes[n][1:])) if len(self.shapes[n]) > 1 else 1
                offs[n] = (total, size)
                total += size
            return offs, total

        self.f_names, self.i_names, self.c_names = f_names, i_names, c_names
        self.offs_f, self.rows_f = offsets(f_names)
        self.offs_i, self.rows_i = offsets(i_names)
        self.offs_c, self.rows_c = offsets(c_names)

    def _leaf(self, state: EnvState, name: str):
        if name in self.phys_names:
            return getattr(state.physics, name)
        prefix, _, key = name.partition(".")
        if prefix == "dr":
            return getattr(state.dr, key)
        if prefix in ("sf", "ff", "ts") and key:
            return {"sf": state.success_flags, "ff": state.failure_flags,
                    "ts": state.task_states}[prefix][key]
        return getattr(state, name)

    def pack(self, state: EnvState) -> FusedEnvState:
        n = state.physics.q.shape[0]

        def rows(names, dtype):
            return torch.cat([self._leaf(state, nm).reshape(n, -1).to(dtype) for nm in names],
                             dim=1).t().contiguous()

        return FusedEnvState(
            rows_f=rows(self.f_names, torch.float32), rows_i=rows(self.i_names, torch.int32),
            rows_c=rows(self.c_names, torch.float32),
            consecutive_successes=state.consecutive_successes, difficulty=state.difficulty)

    def unpack(self, fs: FusedEnvState) -> EnvState:
        n = fs.rows_f.shape[1]
        v: Dict[str, torch.Tensor] = {}
        for names, offs, rows in ((self.f_names, self.offs_f, fs.rows_f),
                                  (self.i_names, self.offs_i, fs.rows_i),
                                  (self.c_names, self.offs_c, fs.rows_c)):
            for nm in names:
                # contiguous, as the unfused step's leaves are: a reduction
                # over a strided view (torch.linalg.vector_norm) may round
                # otherwise
                o, k = offs[nm]
                v[nm] = rows[o:o + k].t().reshape((n,) + self.shapes[nm][1:]).to(
                    self.dtypes[nm]).contiguous()
        sub = lambda p: {k[3:]: v[k] for k in self.f_names + self.i_names if k.startswith(p)}
        return EnvState(
            physics=PhysicsState(**{p: v[p] for p in self.phys_names}),
            full_dof_targets=v["full_dof_targets"],
            active_prev_targets=v["active_prev_targets"],
            active_rule_targets=v["active_prev_targets"],
            prev_actions=v["prev_actions"],
            prev_dof_pos=v["q"],
            contact_duration_steps=v["contact_duration_steps"],
            prev_contact_binary=v["prev_contact_binary"],
            episode_step_count=v["episode_step_count"],
            body_contact_force=v["body_contact_force"],
            prev_finger_dof_vel=v["prev_finger_dof_vel"],
            prev_hand_vel=v["prev_hand_vel"],
            prev_hand_ang_vel=v["prev_hand_ang_vel"],
            prev_contacts=v["prev_contacts"],
            success_flags=sub("sf."), failure_flags=sub("ff."), task_states=sub("ts."),
            consecutive_successes=fs.consecutive_successes,
            dr=DRSample(**{k: v[f"dr.{k}"] for k in DR_FIELDS}),
            difficulty=fs.difficulty,
        )


# ----------------------------------------------------------------------
# the kernel's config buffer: ids shared with csrc/fused_step.cu
# ----------------------------------------------------------------------
OBS_KEYS = (
    "base_dof_pos", "base_dof_vel", "active_finger_dof_pos", "active_finger_dof_vel",
    "all_finger_dof_pos", "all_finger_dof_vel", "hand_pose", "hand_pose_arr_aligned",
    "contact_forces", "contact_force_magnitude", "contact_binary", "contact_duration",
    "prev_actions", "active_prev_targets", "base_dof_target", "active_finger_dof_target",
    "all_finger_dof_target", "fingertip_poses_world", "fingertip_poses_hand",
    "fingerpad_poses_world", "fingerpad_poses_hand", "episode_time",
    # BlindGrasping task observations
    "object_pos", "object_vel", "finger_to_object_distances",
    "avg_finger_to_object_distance", "finger_to_object_height_diff",
    "avg_finger_to_object_height_diff", "hand_to_object_distance", "fingerpad_distances",
    "first_three_fingerpad_centroid", "thumb_contact", "other_fingers_contact",
    "grasp_state", "grasp_duration", "current_stage", "time_in_stage", "stage_progress",
    # BoxStacking's (object_pos, object_vel and finger_to_object_distances above)
    "object_quat", "platform_pos", "platform_quat", "to_stack_target", "stack_dist",
    "fingers_on_box", "hold_duration",
    # the single-box tasks' (BoxReorientation, InHandReorientation, BoxPushing)
    "object_angvel", "object_yaw_sincos", "target_yaw_sincos", "yaw_error", "box_drift",
    "aligned_duration", "object_rel_hand", "target_xy", "to_target", "dist_to_target",
)
# K1's build of each task's step (utils/kernel_build.py BUILDS); the task's
# exact class, so that a subclass with its own step has none
FUSED_BUILDS = {BaseTask: "fused_step_base", BlindGraspingTask: "fused_step",
                BoxStackingTask: "fused_step_stacking", BoxReorientationTask: "fused_step_reorient",
                InHandReorientationTask: "fused_step_inhand", BoxPushingTask: "fused_step_pushing"}
TERM_COMPONENTS = (
    "total", "termination_success", "termination_success_weighted",
    "termination_failure_penalty", "termination_failure_penalty_weighted",
    "termination_timeout_penalty", "termination_timeout_penalty_weighted",
)


def reward_terms_for(task):
    """The kernel's reward-term ids: the common terms, then the task's."""
    return COMMON_TERMS + task.reward_terms


def failure_criteria_for(task):
    """The kernel's failure-criterion ids (success: task.success_criteria)."""
    return ("hitting_ground",) + task.failure_criteria


def build_for(task) -> str:
    """K1's build for this task; raises FusedUnsupported without one."""
    build = FUSED_BUILDS.get(type(task))
    if build is None:
        raise FusedUnsupported(f"task {task.name} has no fused-kernel implementation yet")
    return build


def _check_supported(env) -> None:
    c = env.comps
    if c.engine.params.coriolis:
        # the kernel's lane physics carries no Coriolis bias (the JAX
        # SimParams.coriolis docstring; the JAX fused step does not check
        # it and drops the bias on TPU)
        raise FusedUnsupported("SimParams.coriolis")
    # before the build lookup: a task with hooks is usually a subclass of a
    # task that has a build
    hooks = [h for h, set_ in (("pre_action_rule", c.task.pre_action_rule is not None),
                               ("custom_action_rule", c.task.custom_action_rule is not None),
                               ("custom_post_filters", bool(c.task.custom_post_filters))) if set_]
    if hooks:
        raise FusedUnsupported(f"the task's custom pre-action rule, action rule or filters "
                               f"({', '.join(hooks)}): the kernel runs the builtin ones only")
    build_for(c.task)
    for f in c.pipeline.post_action_filters:
        if f not in ("velocity_clamp", "position_clamp"):
            raise FusedUnsupported(f"unknown post-action filter {f}")
    keys = list(c.obs_cfg.policy_observation_keys) + list(c.obs_cfg.critic_observation_keys)
    planned = set(default_obs_dims(c.obs_cfg)) | set(c.task.obs_dims)
    missing = [k for k in keys if k not in OBS_KEYS or k not in planned]
    if missing:
        raise FusedUnsupported(f"observation keys without a kernel row plan: {missing}")
    if c.obs_cfg.num_contact_bodies > 8 or len(c.obs_cfg.fingertip_site_indices) != 5:
        raise FusedUnsupported("more than 8 contact bodies or not 5 fingertip sites")


def comp_names_for(env):
    """Reward-component packing order: sorted names, as the JAX step's
    sorted extras keys."""
    w = env.comps.reward_cfg.weights
    terms = [t for t in COMMON_TERMS + env.comps.task.reward_terms if w.get(t, 0.0) != 0.0]
    return tuple(sorted([*terms, *(f"{t}_weighted" for t in terms), *TERM_COMPONENTS]))


def template_state(env, n: int) -> EnvState:
    """An all-zero EnvState with the env's leaf shapes and dtypes."""
    c = env.comps
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)
    nc = c.obs_cfg.num_contact_bodies
    b = lambda: z(n, dt=torch.bool)
    task_hg = getattr(c.task, "overrides_hitting_ground", False)
    failure = ({"hitting_ground"} if c.term_cfg.has_height_safety or task_hg else set()) | set(
        c.task.failure_criteria)
    box2 = ({"box2_pos": z(n, 3), "box2_quat": z(n, 4), "box2_linvel": z(n, 3),
             "box2_angvel": z(n, 3)} if c.engine.params.has_box2 else {})
    return EnvState(
        physics=PhysicsState(z(n, NUM_DOFS), z(n, NUM_DOFS), z(n, 3), z(n, 4), z(n, 3), z(n, 3),
                             **box2),
        full_dof_targets=z(n, NUM_DOFS), active_prev_targets=z(n, 18),
        active_rule_targets=z(n, 18), prev_actions=z(n, c.num_actions),
        prev_dof_pos=z(n, NUM_DOFS), contact_duration_steps=z(n, nc, dt=torch.int32),
        prev_contact_binary=z(n, nc), episode_step_count=z(n, dt=torch.int32),
        body_contact_force=z(n, c.model.num_bodies, 3), prev_finger_dof_vel=z(n, 20),
        prev_hand_vel=z(n, 3), prev_hand_ang_vel=z(n, 3),
        prev_contacts=z(n, nc, dt=torch.bool),
        success_flags={k: b() for k in c.term_cfg.active_success(c.task.success_criteria)},
        failure_flags={k: b() for k in c.term_cfg.active_failure(failure)},
        consecutive_successes=z((), dt=torch.int32),
        task_states=c.task.init_task_states(n, "cpu"),
        dr=DRSample.nominal(n, "cpu"), difficulty=z(()),
    )


def operand_rows(reset: TaskReset, dr: DRSample | None, rts_keys, n: int, device,
                 has_box2: bool = False):
    """Reset samples -> rst_T (26 + 7 [+ 7 for the second box] + task rows,
    N); DR -> drn_T (4, N) (ones without DR). The kernel's operand layout."""
    quat = torch.zeros(n, 4, device=device)
    quat[:, 3] = 1.0
    parts = [reset.dof_pos,
             reset.box_pos if reset.box_pos is not None else torch.zeros(n, 3, device=device),
             reset.box_quat if reset.box_quat is not None else quat]
    if has_box2:
        parts += [reset.box2_pos, reset.box2_quat]
    parts += [reset.task_states[k].reshape(n, -1).float() for k in rts_keys]
    rst = torch.cat([p.float() for p in parts], dim=1).t().contiguous()
    drn = dr.rows().contiguous() if dr is not None else torch.ones(4, n, device=device)
    return rst, drn


def fused_config_array(env, layout: FusedLayout, comp_names, rst_rows: int,
                       lib: ctypes.CDLL) -> np.ndarray:
    """The FusedConfig struct (one numpy record) for this env, in the layout
    that `lib` was compiled with."""
    c, pl, task = env.comps, env.comps.pipeline, env.comps.task
    r = np.zeros((), dtype=lane_step.struct_dtype(lib.fused_config_layout))
    r["n_act"] = pl.num_actions
    r["position_mode"] = int(pl.control_mode == "position")
    r["controls_base"], r["controls_fingers"] = pl.policy_controls_base, pl.policy_controls_fingers
    r["n_filters"] = len(pl.post_action_filters)
    for j, f in enumerate(pl.post_action_filters):
        r["filters"][j] = {"velocity_clamp": 1, "position_clamp": 2}[f]
    r["lo"], r["hi"], r["md"] = pl.active_lower, pl.active_upper, pl.max_deltas
    r["csrc"], r["cscale"] = pl.coupling_src, pl.coupling_scale
    r["act_idx"] = action_mod.ACTIVE_IDX
    oc = c.obs_cfg
    r["nc"] = oc.num_contact_bodies
    r["contact_body"][:oc.num_contact_bodies] = oc.contact_body_indices
    r["contact_binary_threshold"], r["control_dt"] = oc.contact_binary_threshold, c.control_dt
    r["hand_b"] = oc.hand_body_index
    r["tip_site"], r["pad_site"] = oc.fingertip_site_indices, oc.fingerpad_site_indices
    keys = list(oc.policy_observation_keys) + list(oc.critic_observation_keys)
    if len(keys) > r["obs_keys"].size:
        raise FusedUnsupported(f"{len(keys)} observation keys, more than the kernel's "
                               f"{r['obs_keys'].size}")
    r["n_obs_keys"] = len(keys)
    r["obs_keys"][:len(keys)] = [OBS_KEYS.index(k) for k in keys]
    r["obs_dim"] = env.num_obs + env.num_states
    r["rows_f"], r["rows_i"], r["rows_c"], r["rst_rows"] = (
        layout.rows_f, layout.rows_i, layout.rows_c, rst_rows)
    in_cap, out_cap = shared_layout(lib)[3:]
    if (layout.rows_f + layout.rows_i + pl.num_actions + rst_rows + 7 > in_cap
            or layout.rows_c + r["obs_dim"] + 5 + len(comp_names) > out_cap):
        raise FusedUnsupported("an env's rows exceed the kernel's staging in shared memory")
    of = lambda k: layout.offs_f[k][0]
    oi = lambda k: layout.offs_i[k][0]
    for k in ("active_prev_targets", "prev_actions", "prev_contact_binary",
              "prev_finger_dof_vel", "prev_hand_vel", "prev_hand_ang_vel", *layout.phys_names):
        r[f"f_{k}"] = of(k)
    r["f_dr"] = [of(f"dr.{k}") for k in DR_FIELDS]
    for k in ("episode_step_count", "contact_duration_steps", "prev_contacts"):
        r[f"i_{k}"] = oi(k)
    r["c_full_dof_targets"] = layout.offs_c["full_dof_targets"][0]
    r["c_body_contact_force"] = layout.offs_c["body_contact_force"][0]
    sflags = sorted(k[3:] for k in layout.i_names if k.startswith("sf."))
    fflags = sorted(k[3:] for k in layout.i_names if k.startswith("ff."))
    r["n_sflags"], r["n_fflags"] = len(sflags), len(fflags)
    r["sflag_crit"][:len(sflags)] = [task.success_criteria.index(k) for k in sflags]
    r["sflag_row"][:len(sflags)] = [oi(f"sf.{k}") for k in sflags]
    r["fflag_crit"][:len(fflags)] = [failure_criteria_for(task).index(k) for k in fflags]
    r["fflag_row"][:len(fflags)] = [oi(f"ff.{k}") for k in fflags]
    tc = c.term_cfg
    r["max_episode_length"] = tc.max_episode_length
    r["success_reward"], r["failure_penalty"] = tc.success_reward, tc.failure_penalty
    r["timeout_penalty"] = tc.timeout_penalty
    r["has_height_safety"] = tc.has_height_safety
    r["handbase_threshold"], r["fingertip_threshold"] = (
        tc.handbase_threshold, tc.fingertip_threshold)
    # the spawn projection of the reset rows (BlindGrasping's)
    r["has_proj"] = int(getattr(task, "spawn_projection", False)
                        and getattr(task, "_min_tip_z_fn", None) is not None)
    r["proj_clear"] = getattr(task, "spawn_projection_clearance", 0.0)
    r["proj_spawn"] = c.spawn_pos
    r["proj_site_mask"] = sum(1 << int(s) for s in oc.fingertip_site_indices)
    w = c.reward_cfg.weights
    terms = reward_terms_for(task)
    rew = [t for t in sorted(terms) if w.get(t, 0.0) != 0.0]
    r["n_rew"] = len(rew)
    r["rew_term"][:len(rew)] = [terms.index(t) for t in rew]
    r["rew_w"][:len(rew)] = [w[t] for t in rew]
    r["n_comp"] = len(comp_names)
    for j, name in enumerate(comp_names):
        if name in TERM_COMPONENTS:
            r["comp_kind"][j] = 2 + TERM_COMPONENTS.index(name)
        elif name.endswith("_weighted") and name[:-9] in terms:
            r["comp_kind"][j], r["comp_idx"][j] = 1, terms.index(name[:-9])
        else:
            r["comp_kind"][j], r["comp_idx"][j] = 0, terms.index(name)
    r["finger_lower"] = c.reward_cfg.finger_lower_limits
    r["finger_upper"] = c.reward_cfg.finger_upper_limits
    if isinstance(task, BlindGraspingTask):
        _blind_grasping_fields(r, task, of, oi, c.control_dt)
    elif isinstance(task, BoxStackingTask):
        _box_stacking_fields(r, task, layout, rst_layout(env)[0])
    elif isinstance(task, (BoxReorientationTask, InHandReorientationTask, BoxPushingTask)):
        _single_box_fields(r, task, layout, rst_layout(env)[0], c.control_dt)
    return r


def rst_layout(env):
    """The reset operand's task-state rows: ({key: (row offset, rows)}, the
    operand's rows), after the 26 dof rows, the box's 7 and the second
    box's 7 (in sorted key order, as `operand_rows` stacks them)."""
    c = env.comps
    o = NUM_DOFS + 7 + (7 if c.engine.params.has_box2 else 0)
    offs = {}
    for k, v in sorted(c.task.init_task_states(1, "cpu").items()):
        offs[k] = (o, max(1, int(np.prod(v.shape[1:]))))
        o += offs[k][1]
    return offs, o


def _blind_grasping_fields(r, t: BlindGraspingTask, of, oi, control_dt) -> None:
    for k in ("initial_box_pos", "stage_contact_duration", "time_in_stage"):
        r[f"f_{k}"] = of(f"ts.{k}")
    for short, k in (("current_stage", "current_stage"), ("just_t2", "just_transitioned_to_stage2"),
                     ("just_t3", "just_transitioned_to_stage3"),
                     ("success_conditions_met", "success_conditions_met"),
                     ("success_duration_steps", "success_duration_steps")):
        r[f"i_{short}"] = oi(f"ts.{k}")
    half = t.box_size / 2.0
    vals = dict(
        bg_contact_thr=t.contact_binary_threshold,
        bg_prox_thr=math.sqrt(3.0) * t.box_size / 2.0 * 1.2,
        bg_height_thr=t.height_threshold, bg_min_fingers=t.min_fingers_for_grasp,
        bg_max_box_dist=t.max_box_distance, bg_s1_dur=t.stage1_duration,
        bg_s2_dur=t.stage2_duration, bg_s2_contact_thr=t.stage2_contact_success_threshold,
        bg_d_ha=t.height_alignment_decay, bg_d_cp=t.centroid_positioning_decay,
        bg_d_os=t.object_stability_decay, bg_d_fhc=t.first_three_height_consistency_decay,
        bg_d_fpp=t.fingerpad_proximity_decay, bg_d_bs=t.base_stability_decay,
        bg_tol_h=t.height_tolerance, bg_tol_c=t.centroid_tolerance,
        bg_tol_drift=t.position_drift_tolerance, bg_tol_vel=t.velocity_tolerance,
        bg_box_z=t.box_z, bg_s3_den=t.height_threshold - t.box_z,
        bg_pen_thr=half * t.geometric_penetration_factor,
        bg_min_reward_dist=half * t.proximity_min_distance_factor,
        bg_pen_scale=t.penetration_depth_scale,
        bg_ub_half=half * t.under_box_footprint_factor, bg_ub_margin=t.under_box_margin,
        bg_ub_ground_z=t.under_box_ground_z, bg_cdt=t.contact_duration_threshold,
        bg_threshold_steps=int(round(t.contact_duration_threshold / control_dt)),
    )
    for k, v in vals.items():
        r[k] = v


def _box_stacking_fields(r, t: BoxStackingTask, layout: FusedLayout, rst):
    for k in ("platform_spawn_xy", "prev_transport_dist", "spawn_difficulty"):
        r[f"f_{k}"] = layout.offs_f[f"ts.{k}"][0]
        r[f"r_{k}"] = rst[k][0]
    r["i_hold_duration_steps"] = layout.offs_i["ts.hold_duration_steps"][0]
    r["r_hold_duration_steps"] = rst["hold_duration_steps"][0]
    vals = dict(
        bs_stack_dz=(t.plat_size + t.box_size) / 2.0, bs_pos_tol=t.position_tolerance,
        bs_height_tol=t.height_tolerance, bs_rest_speed=t.rest_speed_tolerance,
        bs_hold_thr=t.hold_duration_threshold, bs_hold_min=t.hold_anneal_min,
        bs_box_far=t.box_far_threshold, bs_move_tol=t.platform_move_tolerance,
        bs_contact_thr=t.contact_binary_threshold,
        bs_prox_thr=math.sqrt(3.0) * t.box_size / 2.0 * 1.2,
        bs_d_prox=t.proximity_decay, bs_d_transport=t.transport_decay, bs_d_place=t.place_decay,
        bs_release_end=t.release_anneal_end, bs_tol_relax=t.tolerance_relax,
        bs_hg_override=int(t.overrides_hitting_ground),
        bs_tip_bridge_margin=t.fingertip_bridge_margin, bs_pocket_margin=t.pocket_margin,
        bs_pocket_radius=t.pocket_radius, bs_pocket_end=t.pocket_anneal_end,
        bs_handbase_thr=t.handbase_threshold, bs_fingertip_thr=t.fingertip_threshold,
        bs_lift_z=t.box_z + 0.02, bs_ub_half=t.box_size / 2.0 * t.under_box_footprint_factor,
        bs_ub_margin=t.under_box_margin, bs_ub_ground_z=t.under_box_ground_z,
        bs_drift_free=t.drift_free_margin,
    )
    for k, v in vals.items():
        r[k] = v


def _single_box_fields(r, t, layout: FusedLayout, rst, control_dt) -> None:
    """The rows and constants of the single-box tasks' steps: each task
    state's row in rows_f or rows_i and in the reset operand (every one of
    them comes from the sampled reset rows)."""
    for k in t.init_task_states(1, "cpu"):
        name = f"ts.{k}"
        if name in layout.offs_f:
            r[f"f_{k}"] = layout.offs_f[name][0]
        else:
            r[f"i_{k}"] = layout.offs_i[name][0]
        r[f"r_{k}"] = rst[k][0]
    hold = (t.hold_duration_threshold if isinstance(t, BoxPushingTask)
            else t.align_duration_threshold)
    vals = dict(t_contact_thr=t.contact_binary_threshold,
                t_prox_thr=math.sqrt(3.0) * t.box_size / 2.0 * 1.2,
                t_thr_steps=int(round(hold / control_dt)))
    if isinstance(t, BoxPushingTask):
        vals.update(t_lift_z=t.box_z + t.lift_tolerance, t_d_prox=t.proximity_decay,
                    bp_pos_tol=t.position_tolerance, bp_rest_speed=t.rest_speed_tolerance,
                    bp_overshoot=t.max_overshoot, bp_d_dist=t.distance_decay)
    else:
        vals.update(ro_period=t.period, ro_yaw_tol=t.yaw_tolerance,
                    ro_d_orient=t.orientation_decay)
    if isinstance(t, BoxReorientationTask):
        vals.update(t_lift_z=t.box_z + t.lift_tolerance, t_d_prox=t.proximity_decay,
                    ro_drift_tol=t.position_drift_tolerance, ro_max_drift=t.max_drift,
                    ro_d_drift=t.drift_decay)
    elif isinstance(t, InHandReorientationTask):
        vals.update(ih_hang_z=t.hang_z, ih_drop_band=t.drop_band,
                    ih_drop_z=t.hang_z - t.drop_band, ih_escape=t.escape_distance,
                    ih_d_height=t.height_decay)
    for k, v in vals.items():
        r[k] = v


# f32 operations of fs_env_step (csrc/fused_step.cu) outside the lane
# physics, counted from its code as lane_step counts the physics: each add,
# mul, compare/select, divide and sqrt/exp counts one; integer work none.
# fs_norm3 is 9; fs_pose_hand is 3 subs, 3 negations, a rotation and a product.
_NORM3 = 9
_POSE_HAND = 6 + lane_step._QROT + lane_step._QMUL
_OBS_KEY_FLOPS = {"hand_pose_arr_aligned": lane_step._QMUL, "episode_time": 1,
                  "fingertip_poses_hand": 5 * _POSE_HAND,
                  "fingerpad_poses_hand": 5 * _POSE_HAND,
                  "avg_finger_to_object_distance": 5, "avg_finger_to_object_height_diff": 5}
_COMP_KIND_FLOPS = (0, 1, 0, 1, 2, 1, 3, 1, 3)  # by comp_kind (CK_* in fused_step.cu)


# each task step's f32 operations per env (fs_task_step and fs_task_merge):
# BlindGrasping's 5 pad distances and height diffs, hand distance, 10
# pad-pair distances, centroid, box contact, stage machine, pregrasp checks
# (3 norms), box-too-far, and its rewards (lowest tip distance 5 norms,
# under-box 58); BoxStacking's stack target and its distances, 5 pad
# distances, finger-box contact, the bridge, stacked, hold and criteria, the
# per-tip hitting-ground check (5 x 13), its rewards (under-box 35) and the
# second box's 13 merge selects; the single-box tasks' fingers on the box
# (box contact, 5 pad distances and checks), then BoxReorientation's and
# InHandReorientation's yaw (10), symmetric error (6), 4 sines and cosines,
# drift or hand distance and height error, aligned counter, rewards and
# merge, and BoxPushing's target distance, speed, hold counter, criteria,
# rewards and merge
_FINGERS_ON_BOX = _NORM3 + 1 + 5 * (_NORM3 + 3)
_TASK_FLOPS = {
    "fused_step_reorient": (10 + 6 + 4 + _FINGERS_ON_BOX + 6 + 2 + 1 + 2 + 2 + 2 + 1 + 1 + 1
                            + 6 + 2 + 1 + 5),
    "fused_step_inhand": (10 + 6 + 4 + _FINGERS_ON_BOX + 9 + 2 + 5 + 1 + 2 + 1 + 2 + 2 + 2 + 1
                          + 1 + 1 + 2 + 2),
    "fused_step_pushing": (2 + 4 + 6 + _FINGERS_ON_BOX + 2 + 1 + 2 + 2 + 1 + 2 + 1 + 6 + 1 + 1
                           + 4),
    "fused_step": (5 * _NORM3 + 10 + _NORM3 + 10 * _NORM3 + 9 + _NORM3 + 1 + 10 + 1 + 1 + 1 + 3
                   + 3 + 2 + 5 + 3 + 3 * _NORM3 + 3 + 1 + 9 + 4 + 5 + 16 + 5 + 3 + 5 * _NORM3
                   + 4 + 4 + 16 + 10 + 2 + 3 + 58),
    "fused_step_stacking": (1 + 3 + 6 + 4 + 1 + 6 + 5 * _NORM3 + 7 + 15 + 3 + 2 + 4 + 3 + 3 + 2
                            + 3 + 2 + 5 + 4 + 2 + 3 + 5 * 13 + 2 + 4 + 2 + 2 + 2 + 3 + 1 + 3 + 3
                            + 5 * 7 + 2 + 3 + 13),
    "fused_step_base": 0,
}


def fused_step_flops(cfg: np.ndarray, model: np.ndarray, n_envs: int, n_done: int,
                     build: str = "fused_step") -> int:
    """f32 operations of one launch of K1's `build` on `n_envs` envs of which
    `n_done` reset, from the FusedConfig and LaneModel records it runs
    with."""
    nb, nc = int(model["nb"]), int(cfg["nc"])
    n_rew = int(cfg["n_rew"])
    pos = bool(cfg["position_mode"])
    n_on = 6 * int(cfg["controls_base"]) + 12 * int(cfg["controls_fingers"])
    action = (n_on * (5 if pos else 2) + (0 if pos else 2 * 18) + 3 * nb
              + sum(18 * (5 if f == 1 else 2) for f in cfg["filters"][:int(cfg["n_filters"])]))
    default_obs = 2 * nb + 11 * nc               # dof velocities, contact rows
    task = _TASK_FLOPS[build]
    termination = 8 + 4 + 2                      # + lowest tip, hitting ground
    # common terms (finger velocity and acceleration norms 100, joint limits
    # 222, hand velocity and acceleration 4 norms), the weighted sum
    rewards = (100 + 7 + 3 + 2 * (_NORM3 + 2) + 222 + 3 + 2 * (_NORM3 + 2) + 1 + 3
               + 3 * nc + 2 * n_rew)
    keys = [OBS_KEYS[k] for k in cfg["obs_keys"][:int(cfg["n_obs_keys"])]]
    outputs = (sum(_OBS_KEY_FLOPS.get(k, 0) for k in keys)
               + nc * keys.count("contact_duration") + 1
               + sum(_COMP_KIND_FLOPS[k] for k in cfg["comp_kind"][:int(cfg["n_comp"])]))
    merge = 6 * nb + int(cfg["n_act"]) + nc + 66  # float selects of the reset merge
    physics = lane_step.control_step_flops(model, n_sites=10)  # 5 tip + 5 pad sites
    per_env = physics + action + default_obs + task + termination + rewards + outputs + merge
    n_proj = int(cfg["has_proj"]) * n_done
    return n_envs * per_env + n_proj * (lane_step.min_site_z_flops(model, 5) + 3)


def shared_layout(lib: ctypes.CDLL):
    """K1's shared memory per env (bytes), envs per block, the design's
    budget per env (bytes), and the words per env its staged input column
    and its output rows may take (`fused_step_shared` in fused_step.cu)."""
    vals = [ctypes.c_int() for _ in range(5)]
    lib.fused_step_shared(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def _lib(build: str) -> ctypes.CDLL:
    lib = kb.load(build)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_step_launch.argtypes = [P] * 13 + [I, P]
        lib._typed = True
    return lib


def build_fused_step(env, lib: ctypes.CDLL | None = None):
    """The fused step for a DexHandEnv: a namespace with `step_fn(fs,
    actions, operands=None)`, `pack`/`unpack`, `reset()`, `comp_names`,
    `layout`, `obs_dim`, `kernel` (the raw K1 wrapper on rows) and
    `kernel_plain` (its plain version). Raises FusedUnsupported.

    `lib` is the K1 library the wrapper launches: by default the task's
    build, compiled by nvcc, for an env on the card, and none for an env on
    the CPU, where the wrapper runs the plain version. The config record is
    built here from it, so a configuration whose rows do not fit that
    build's staging in shared memory raises FusedUnsupported now, not at
    the first launch (and `fused=auto` falls back to the unfused step)."""
    _check_supported(env)
    c = env.comps
    build = build_for(c.task)
    has_box2 = c.engine.params.has_box2
    layout = FusedLayout(template_state(env, 1))
    comp_names = comp_names_for(env)
    rts, rst_rows = rst_layout(env)
    rts_keys = sorted(rts)
    obs_dim = env.num_obs + env.num_states
    n_comp = len(comp_names)
    bufs: Dict[str, torch.Tensor] = {}
    sd_row = layout.offs_f.get("ts.spawn_difficulty", (None,))[0]
    if lib is None and c.engine.device.type == "cuda":
        lib = _lib(build)
    if lib is not None:
        bufs["cfg"] = lane_step.record_buffer(
            fused_config_array(env, layout, comp_names, rst_rows, lib), c.engine.device)

    def reset_from_rows(rst_T) -> TaskReset:
        """Inverse of `operand_rows` for the reset values."""
        n, rst = rst_T.shape[1], rst_T.t()
        tmpl = c.task.init_task_states(1, rst_T.device)
        ts = {k: rst[:, o:o + size].reshape((n,) + tmpl[k].shape[1:]).to(tmpl[k].dtype)
              for k, (o, size) in rts.items()}
        d = NUM_DOFS
        box2 = (dict(box2_pos=rst[:, d + 7:d + 10], box2_quat=rst[:, d + 10:d + 14])
                if has_box2 else {})
        return TaskReset(dof_pos=rst[:, :d], box_pos=rst[:, d:d + 3], box_quat=rst[:, d + 3:d + 7],
                         task_states=ts, **box2)

    def kernel(rows_f, rows_i, act_T, rst_T, drn_T, spw_T):
        """K1 on rows; rows_f/rows_i are updated in place. Returns (rows_c,
        obs (obs_dim, N), rew (1, N), masks (4, N) i32, comps (n_comp, N))."""
        if rows_f.device.type == "cpu":
            return kernel_plain(rows_f, rows_i, act_T, rst_T, drn_T, spw_T)
        lane_step.require_cuda(rows_f)
        n = rows_f.shape[1]
        # raises unless the operands are on the engine's device, where both
        # buffers live (a CUDA engine's: its library and config are built)
        model = lane_step.model_buffer(c.engine, c.physics_steps_per_control, lib,
                                       rows_f.device)
        ins = [lane_step.check_rows(rows_f, layout.rows_f, n),
               lane_step.check_rows(rows_i, layout.rows_i, n, torch.int32),
               lane_step.check_rows(act_T, c.num_actions, n),
               lane_step.check_rows(rst_T, rst_rows, n),
               lane_step.check_rows(drn_T, 4, n), lane_step.check_rows(spw_T, 3, n)]
        e = lambda r, dt=torch.float32: torch.empty(r, n, dtype=dt, device=rows_f.device)
        outs = [e(layout.rows_c), e(obs_dim), e(1), e(4, torch.int32), e(n_comp)]
        kb.check(lib.fused_step_launch(model.data_ptr(), bufs["cfg"].data_ptr(), *ins,
                                       *(o.data_ptr() for o in outs), n,
                                       kb.stream_ptr(rows_f.device)), build)
        kb.LAUNCHES[build] += 1
        return tuple(outs)

    def kernel_plain(rows_f, rows_i, act_T, rst_T, drn_T, spw_T):
        """The plain version of K1: unpack, the env's plain step with these
        operands, pack (rows_f/rows_i written in place)."""
        n = rows_f.shape[1]
        dev = rows_f.device
        fs = FusedEnvState(rows_f, rows_i, torch.zeros(layout.rows_c, n, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev),
                           torch.zeros((), device=dev))
        state = layout.unpack(fs)
        dr = DRSample(*drn_T)
        if not torch.equal(spw_T.t(), env._spawn.expand(n, 3)):
            raise ValueError("spawn rows differ from the env's spawn position")
        new, obs, rew, done, extras = env._step(state, act_T.t(), reset_from_rows(rst_T), dr,
                                                env._plain_control_step)
        packed = layout.pack(new)
        rows_f.copy_(packed.rows_f)
        rows_i.copy_(packed.rows_i)
        masks = torch.stack([done, extras["success"], extras["failure"],
                             extras["timeout"]]).to(torch.int32)
        comps = torch.stack([extras["reward_components"][k] for k in comp_names])
        return packed.rows_c, obs.t().contiguous(), rew[None], masks, comps

    def step_fn(fs: FusedEnvState, actions, operands=None):
        """One fused step. `operands` = (rst_T, drn_T); drawn from the env's
        generator (reset values unprojected) when omitted."""
        n = actions.shape[0]
        if math.isfinite(c.clip_actions):
            actions = actions.clamp(-c.clip_actions, c.clip_actions)
        if operands is None:
            reset, dr = env.draw_samples(n, fs.difficulty)
            operands = operand_rows(reset, dr, rts_keys, n, actions.device, has_box2)
        rst_T, drn_T = operands
        spw_T = env._spawn[:, None].expand(3, n).contiguous()
        strict = None
        if sd_row is not None:
            # the curriculum's strict gate, as the unfused step: the pre-step
            # spawn difficulty, read before the kernel overwrites the rows
            strict = fs.rows_f[sd_row] >= fs.difficulty - 1e-4
        rows_c, obs_T, rew_T, msk_T, cmp_T = kernel(
            fs.rows_f, fs.rows_i, actions.t().contiguous(), rst_T, drn_T, spw_T)
        obs = obs_T.t()
        if math.isfinite(c.clip_observations):
            obs = obs.clamp(-c.clip_observations, c.clip_observations)
        done, succ = msk_T[0] != 0, msk_T[1] != 0
        consecutive = torch.where(
            env.any_rank(succ), torch.clamp(fs.consecutive_successes + 1,
                                    max=c.term_cfg.max_consecutive_successes),
            torch.zeros_like(fs.consecutive_successes))
        new = FusedEnvState(fs.rows_f, fs.rows_i, rows_c, consecutive, fs.difficulty)
        extras = {"success": succ, "failure": msk_T[2] != 0, "timeout": msk_T[3] != 0,
                  "reward_components_packed": cmp_T.t()}
        if strict is not None:
            extras["success_strict"] = succ & strict
            extras["done_strict"] = done & strict
        return new, obs, rew_T[0], done, extras

    def reset(samples=None):
        state, obs = env.reset_fn(samples)
        return layout.pack(state), obs

    return SimpleNamespace(
        step_fn=step_fn, pack=layout.pack, unpack=layout.unpack, reset=reset,
        comp_names=comp_names, layout=layout, obs_dim=obs_dim, rst_rows=rst_rows,
        rts_keys=rts_keys, kernel=kernel, kernel_plain=kernel_plain,
        reset_from_rows=reset_from_rows,
        operand_rows=lambda reset, dr, n, device: operand_rows(reset, dr, rts_keys, n, device,
                                                               has_box2),
        build=build,
    )

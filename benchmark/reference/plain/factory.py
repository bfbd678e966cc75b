"""Environment factory: config dict -> task -> DexHandEnv (torch).

The port's counterpart of `dexrobot_isaac_tpu/factory.py`. `make_env` runs
on the CUDA card unless the caller passes `device="cpu"`; it raises when
CUDA is missing rather than falling back. `env.handAsset` loads the hand
from an MJCF file (models/mjcf.py) in place of the built-in model.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Type

import numpy as np
import torch

from benchmark.reference.plain.constants import NUM_DOFS
from benchmark.reference.plain.envs import action as action_mod
from benchmark.reference.plain.envs import observations as obs_mod
from benchmark.reference.plain.envs import rewards as rew_mod
from benchmark.reference.plain.envs import termination as term_mod
from benchmark.reference.plain.envs.dexhand import DexHandEnv, EnvComponents
from benchmark.reference.plain.envs.tasks.api import DexTask
from benchmark.reference.plain.envs.tasks.base_task import BaseTask
from benchmark.reference.plain.envs.tasks.blind_grasping import BlindGraspingTask
from benchmark.reference.plain.envs.tasks.box_stacking import BoxStackingTask
from benchmark.reference.plain.models.dexhand021 import build_hand_model
from benchmark.reference.plain.parallel.mesh import Group, single_process
from benchmark.reference.plain.physics.engine import HandPhysics
from benchmark.reference.plain.physics.types import SimParams
from benchmark.reference.plain.utils.config import get_by_path
from benchmark.reference.plain.utils.device import resolve_device

TASK_REGISTRY: Dict[str, Type[DexTask]] = {
    "BaseTask": BaseTask,
    "BlindGrasping": BlindGraspingTask,
    "BoxStacking": BoxStackingTask,
}


def _parse_dr(dr_cfg):
    if not dr_cfg or not dr_cfg.get("enabled", False):
        return None
    return {k: (float(dr_cfg[k][0]), float(dr_cfg[k][1]))
            for k in ("kp_scale", "kd_scale", "box_mass_scale", "friction_scale")
            if k in dr_cfg}


def build_sim_params(cfg: Dict[str, Any]) -> SimParams:
    sim = cfg.get("sim", {})
    contact = sim.get("contact", {})
    return SimParams(
        dt=float(sim.get("dt", 0.005)),
        substeps=int(sim.get("substeps", 4)),
        gravity=float(sim.get("gravity", -9.81)),
        contact_stiffness=float(contact.get("stiffness", 8000.0)),
        contact_damping=float(contact.get("damping", 60.0)),
        friction_stiffness=float(contact.get("friction_stiffness", 400.0)),
        contact_beta=float(contact.get("beta", 0.2)),
        max_depenetration_velocity=float(contact.get("max_depenetration_velocity", 0.2)),
        ground_friction=float(sim.get("ground_friction", 1.0)),
        hand_friction=float(sim.get("hand_friction", 1.0)),
        self_collision=bool(sim.get("self_collision", True)),
        coriolis=bool(sim.get("coriolis", False)),
    )


def _reject_nonzero_restitution(node: Any, path: str = "task") -> None:
    """The penalty contact model has no restitution term: only 0.0 is
    honored."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "restitution":
                if float(v) != 0.0:
                    raise NotImplementedError(f"{path}.{k}={v}: only 0.0 is supported")
            else:
                _reject_nonzero_restitution(v, f"{path}.{k}")


def make_env(cfg: Dict[str, Any], seed: Optional[int] = None, device="cuda",
             group: Optional[Group] = None) -> DexHandEnv:
    """The env of a composed config; with `group`, this rank's shard of
    `numEnvs` (which must divide over the ranks) and its generator."""
    device = resolve_device(device)
    task_cfg = dict(cfg.get("task", {}))
    _reject_nonzero_restitution(task_cfg)
    env_cfg = cfg.get("env", {})
    task_name = task_cfg.get("name", "BaseTask")
    if task_name not in TASK_REGISTRY:
        raise ValueError(f"Unknown task '{task_name}' (ported: {sorted(TASK_REGISTRY)})")
    task_cfg.setdefault("hand_spawn", env_cfg.get("initialHandPos", [0.0, 0.0, 0.5]))
    task = TASK_REGISTRY[task_name](task_cfg)
    hand_asset = env_cfg.get("handAsset")
    if hand_asset:
        raise NotImplementedError("the reference builds the built-in hand only")
    model = build_hand_model()
    params = task.configure_scene(build_sim_params(cfg))
    engine = HandPhysics(model=model, params=params, device=device)
    steps = int(get_by_path(cfg, "sim.physics_steps_per_control", 4))
    control_dt = params.dt * steps
    pipeline = action_mod.build_action_pipeline(
        model=model,
        control_mode=task_cfg.get("controlMode", "position"),
        control_dt=control_dt,
        policy_controls_base=bool(task_cfg.get("policy_controls_hand_base", True)),
        policy_controls_fingers=bool(task_cfg.get("policy_controls_fingers", True)),
        max_base_linear_velocity=float(task_cfg.get("max_base_linear_velocity", 0.5)),
        max_base_angular_velocity=float(task_cfg.get("max_base_angular_velocity", 1.5)),
        max_finger_joint_velocity=float(task_cfg.get("max_finger_joint_velocity", 1.0)),
        custom_action_rule=task.custom_action_rule,
        custom_filters=task.custom_post_filters,
    )
    obs_cfg = obs_mod.build_obs_config(
        model=model,
        policy_observation_keys=task_cfg.get("policy_observation_keys", []),
        contact_force_bodies=task_cfg.get(
            "contact_force_bodies", ["r_f_link%d_4" % f for f in range(1, 6)]),
        contact_binary_threshold=task_cfg.get("contact_binary_threshold", 1.0),
        control_dt=control_dt,
        num_actions=pipeline.num_actions,
        critic_observation_keys=task_cfg.get("critic_observation_keys", []),
    )
    weights = dict(task_cfg.get("reward_weights", {}))
    reward_cfg = rew_mod.RewardConfig(
        weights=weights,
        finger_lower_limits=np.asarray(model.lower_limit[6:], dtype=np.float32),
        finger_upper_limits=np.asarray(model.upper_limit[6:], dtype=np.float32),
    )
    term = task_cfg.get("termination", {})
    hs = term.get("height_safety", {})
    term_cfg = term_mod.TerminationConfig(
        active_success_criteria=tuple(term.get("active_success_criteria", [])),
        active_failure_criteria=tuple(term.get("active_failure_criteria", [])),
        max_episode_length=int(env_cfg.get("episodeLength", 300)),
        success_reward=float(weights.get("termination_success", 0.0)),
        failure_penalty=float(weights.get("termination_failure_penalty", 0.0)),
        timeout_penalty=float(weights.get("termination_timeout_penalty", 0.0)),
        handbase_threshold=float(hs.get("handbase_threshold", 0.0)),
        fingertip_threshold=float(hs.get("fingertip_threshold", 0.0)),
        has_height_safety="height_safety" in term,
        max_consecutive_successes=int(task_cfg.get("max_consecutive_successes", 50)),
    )
    spawn = np.asarray(env_cfg.get("initialHandPos", [0.0, 0.0, 0.5]), dtype=np.float32)
    shard = (group or single_process(device)).shard_slice(int(env_cfg.get("numEnvs", 1024)))
    comps = EnvComponents(
        num_envs=shard.stop - shard.start,
        model=model, engine=engine, pipeline=pipeline, obs_cfg=obs_cfg,
        reward_cfg=reward_cfg, term_cfg=term_cfg, task=task,
        physics_steps_per_control=steps, control_dt=control_dt,
        spawn_pos=spawn, default_dof_pos=np.zeros(NUM_DOFS, dtype=np.float32),
        clip_observations=float(env_cfg.get("clipObservations", math.inf)),
        clip_actions=float(env_cfg.get("clipActions", math.inf)),
        device=device,
        dr_ranges=_parse_dr(task_cfg.get("domain_randomization")),
        initial_difficulty=(
            float(get_by_path(task_cfg, "curriculum.initial_difficulty", 0.0))
            if get_by_path(task_cfg, "curriculum.enabled", False) else 1.0),
    )
    if seed is None:
        seed = int(get_by_path(cfg, "train.seed", 42))

    # spawn-validity projection: the lowest fingertip z of sampled poses,
    # through the SAME min_site_z the fused kernel runs on its reset rows
    # (the kernel on a CUDA tensor, the plain FK on a CPU tensor)
    if getattr(task, "_min_tip_z_fn", "absent") is None:
        tips = [int(x) for x in obs_cfg.fingertip_site_indices]
        spawn_t = torch.as_tensor(spawn, device=device)

        def _min_tip_z(dof_pos):
            return engine.min_site_z(dof_pos, spawn_t.expand(dof_pos.shape[0], 3), tips)

        task._min_tip_z_fn = _min_tip_z
    return DexHandEnv(comps, seed=seed, group=group)

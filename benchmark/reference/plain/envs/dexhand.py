"""DexHand environment (torch): the functional step + stateful wrapper.

The port's counterpart of `dexrobot_isaac_tpu/envs/dexhand.py`. One control
step is

    step(state, actions) -> (state', obs, reward, done, extras)

action pipeline -> `physics_steps_per_control` physics steps -> obs dict ->
task -> termination -> rewards -> masked auto-reset. Observations returned
for done envs are the terminal ones.

Random draws: reset values and DR scales are sampled from the env's
`torch.Generator` (`draw_samples`), unprojected, and the step projects the
reset poses itself (spawn projection through `min_site_z`), exactly as the
fused kernel takes them as operands. A caller may pass its own samples
(`samples=`), which is how the tests feed JAX-sampled values.

Physics: on a CUDA tensor `step_fn` runs the lane-physics kernel
(`physics/lane_step.py`), on a CPU tensor its plain version. Two-box scenes
(`SimParams.has_box2`, BoxStacking) carry the second box's state, reset it
from the task's `box2_pos`/`box2_quat` and hand its contact force to the
task.

Action hooks: a task's `pre_action_rule(active_prev_targets, obs_dict)` runs
after the observations of each step (and of the reset), and its output,
carried as `EnvState.active_rule_targets`, is what the next step's action
rule starts from (the segments the policy does not control keep it). Its
`custom_action_rule` and `custom_post_filters` sit in the action pipeline
(`envs/action.py`). The fused step declines all three.

Ranks (`group`, parallel/mesh.py): the env holds its rank's shard of the
envs (`num_envs` is the local count, `parallel/distributed.py`
`make_sharded_env`) and draws from its own generator, seeded
`group.rank_seed(seed)` (JAX folds the shard index into its reset and DR
keys, `envs/dexhand.py:222-225`, `:443-446`). The consecutive-successes
counter counts a success on any rank: one int32 all-reduced (max) per step,
on the device (JAX `pmax`, `:301-306`). `step_fn` averages the float
scalar extras, the termination rates and criterion means, over the ranks
in one all-reduce per step (JAX `pmean`s its scalar extras, `:421-427`);
`consecutive_successes` is global by the max. The fused step's extras
have no such keys, as JAX's.

The stateful wrapper carries the JAX env's user API: `reset`/`step`,
`observation_space`/`action_space`, `set_difficulty`, `get_obs_slice` and
the `get_obs_index_for_*` lookups, `toggle_random_actions`, `seed` and
`close`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.plain.constants import BASE_JOINT_NAMES, NUM_DOFS
from benchmark.reference.plain.envs import action as action_mod
from benchmark.reference.plain.envs import observations as obs_mod
from benchmark.reference.plain.envs import rewards as rew_mod
from benchmark.reference.plain.envs import termination as term_mod
from benchmark.reference.plain.envs.tasks.api import DexTask, TaskReset
from benchmark.reference.plain.envs.types import EnvState
from benchmark.reference.plain.models.dexhand021 import HandModel
from benchmark.reference.plain.parallel.mesh import Group, single_process
from benchmark.reference.plain.physics.engine import HandPhysics
from benchmark.reference.plain.physics.types import DRSample, PhysicsState


@dataclasses.dataclass
class EnvComponents:
    """Everything static the step function closes over."""

    num_envs: int
    model: HandModel
    engine: HandPhysics
    pipeline: action_mod.ActionPipeline
    obs_cfg: obs_mod.ObsConfig
    reward_cfg: rew_mod.RewardConfig
    term_cfg: term_mod.TerminationConfig
    task: DexTask
    physics_steps_per_control: int
    control_dt: float
    spawn_pos: np.ndarray           # (3,)
    default_dof_pos: np.ndarray     # (26,)
    clip_observations: float
    clip_actions: float
    device: torch.device
    dr_ranges: Optional[Dict[str, Any]] = None   # None => DR disabled
    initial_difficulty: float = 1.0

    @property
    def num_actions(self) -> int:
        return self.pipeline.num_actions


def _where(m, a, b):
    """Per-env select: m (N,) bool broadcast over trailing dims of b."""
    a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    return torch.where(m.reshape(m.shape + (1,) * (b.ndim - 1)), a, b)


class DexHandEnv:
    def __init__(self, comps: EnvComponents, seed: int = 42, group: Optional[Group] = None):
        c = self.comps = comps
        self.device = comps.device
        self.group = group if group is not None else single_process(self.device)
        self.num_envs = comps.num_envs
        self.num_actions = comps.num_actions
        self.control_dt = comps.control_dt
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.group.rank_seed(seed))
        self._spawn = torch.as_tensor(np.asarray(comps.spawn_pos, np.float32), device=self.device)
        self._default_dof = torch.as_tensor(
            np.asarray(comps.default_dof_pos, np.float32), device=self.device)
        self._control_step = comps.engine.make_control_step(comps.physics_steps_per_control)
        self._plain_control_step = comps.engine.plain_control_step(
            comps.physics_steps_per_control)
        dims = {**obs_mod.default_obs_dims(c.obs_cfg), **c.task.obs_dims}
        self.obs_dims = dims
        self.num_obs = sum(dims[k] for k in c.obs_cfg.policy_observation_keys)
        self.num_states = sum(dims[k] for k in c.obs_cfg.critic_observation_keys)
        failure_names = {"hitting_ground", *c.task.failure_criteria}
        c.term_cfg.validate(set(c.task.success_criteria), failure_names)
        self.state: Optional[EnvState] = None
        # key -> (start, end) in the policy observation tensor
        self.obs_slices: Dict[str, Tuple[int, int]] = {}
        ofs = 0
        for k in c.obs_cfg.policy_observation_keys:
            self.obs_slices[k] = (ofs, ofs + dims[k])
            ofs += dims[k]
        self._random_actions = False

    # ------------------------------------------------------------------
    def draw_samples(self, n: int, difficulty) -> Tuple[TaskReset, Optional[DRSample]]:
        """Unprojected reset values and fresh DR scales (None without DR)."""
        c = self.comps
        reset_vals = c.task.reset_task(self.generator, n, self._default_dof,
                                       difficulty=difficulty, project=False)
        dr = DRSample.sample(self.generator, n, c.dr_ranges) if c.dr_ranges else None
        return reset_vals, dr

    def any_rank(self, mask: torch.Tensor) -> torch.Tensor:
        """Whether `mask` holds anywhere on any rank: a 0-d bool tensor."""
        return self.group.all_reduce_max(mask.any().to(torch.int32)) > 0

    def _check_reset_vals(self, reset_vals: TaskReset) -> None:
        """A two-box scene needs the second box's reset pose from the task."""
        if self.comps.engine.params.has_box2 and (
                reset_vals.box2_pos is None or reset_vals.box2_quat is None):
            raise ValueError(f"task {self.comps.task.name!r} configures a has_box2 scene but "
                             "reset_task did not provide box2_pos/box2_quat")

    def _observe(self, phys, kin, state_like, task_states):
        """Default and task observations, the pre-action rule, the obs
        buffer: (obs_dict, obs_buf, tstep, active_rule, duration, binary)."""
        c = self.comps
        obs_dict, new_duration, binary = obs_mod.compute_default_observations(
            c.obs_cfg, kin, phys.q, state_like["prev_dof_pos"],
            state_like["full_dof_targets"], state_like["active_prev_targets"],
            state_like["prev_actions"], state_like["body_contact_force"],
            state_like["contact_duration_steps"], state_like["prev_contact_binary"],
            state_like["episode_step_count"],
        )
        # the second box's force goes to the task only in two-box scenes
        extra = ({"box2_contact_force": state_like["box2_contact_force"]}
                 if state_like.get("box2_contact_force") is not None else {})
        tstep = c.task.compute_step(obs_dict, task_states, phys, kin,
                                    state_like["body_contact_force"],
                                    state_like["box_contact_force"], c.control_dt, **extra)
        obs_dict.update(tstep.task_obs)
        # the pre-action rule (identity without one); its output is the next
        # step's active_rule_targets
        if c.task.pre_action_rule is not None:
            active_rule = c.task.pre_action_rule(state_like["active_prev_targets"], obs_dict)
        else:
            active_rule = state_like["active_prev_targets"]
        obs_buf = obs_mod.concat_selected_observations(c.obs_cfg, obs_dict)
        if c.obs_cfg.critic_observation_keys:
            obs_buf = torch.cat([obs_buf, obs_mod.concat_selected_observations(
                c.obs_cfg, obs_dict, keys=c.obs_cfg.critic_observation_keys)], dim=-1)
        if math.isfinite(c.clip_observations):
            obs_buf = obs_buf.clamp(-c.clip_observations, c.clip_observations)
        return obs_dict, obs_buf, tstep, active_rule, new_duration, binary

    def step_fn(self, state: EnvState, actions, samples=None):
        """One control step. `samples` = (TaskReset unprojected, DRSample or
        None); drawn from the env's generator when omitted."""
        n = state.physics.q.shape[0]
        if samples is None:
            samples = self.draw_samples(n, state.difficulty)
        new, obs, rew, done, extras = self._step(state, actions, *samples, self._control_step)
        rates = {k: v for k, v in extras.items()
                 if isinstance(v, torch.Tensor) and v.ndim == 0 and v.is_floating_point()}
        return new, obs, rew, done, {**extras, **self.group.all_reduce_mean(rates)}

    def _step(self, state: EnvState, actions, reset_vals: TaskReset, dr_new, control_step):
        c = self.comps
        n = state.physics.q.shape[0]
        if math.isfinite(c.clip_actions):
            actions = actions.clamp(-c.clip_actions, c.clip_actions)
        full, active = action_mod.process_actions(
            c.pipeline, actions, state.active_prev_targets, state.active_rule_targets)
        spawn = self._spawn.expand(n, 3)
        phys, info, kin = control_step(state.physics, full, spawn, state.dr)
        state_like = {
            "prev_dof_pos": state.prev_dof_pos,
            "full_dof_targets": full,
            "active_prev_targets": active,
            "prev_actions": actions,
            "body_contact_force": info.body_contact_force,
            "box_contact_force": info.box_contact_force,
            "box2_contact_force": info.box2_contact_force,
            "contact_duration_steps": state.contact_duration_steps,
            "prev_contact_binary": state.prev_contact_binary,
            "episode_step_count": state.episode_step_count,
        }
        obs_dict, obs_buf, tstep, active_rule, new_duration, binary = self._observe(
            phys, kin, state_like, state.task_states)
        new_count = state.episode_step_count + 1
        failure = {**term_mod.builtin_failure_criteria(c.term_cfg, obs_dict),
                   **tstep.failure_criteria}
        done, term_info, term_reward, term_comps, new_s, new_f = term_mod.evaluate_termination(
            c.term_cfg, new_count, tstep.success_criteria, failure,
            state.success_flags, state.failure_flags)
        hb = c.obs_cfg.hand_body_index
        dof_vel = torch.cat([obs_dict["base_dof_vel"], obs_dict["all_finger_dof_vel"]], dim=-1)
        common, rtrack = rew_mod.compute_common_reward_terms(
            c.reward_cfg, obs_dict, phys.q, dof_vel, kin.body_linvel[:, hb],
            kin.body_angvel[:, hb], state.prev_finger_dof_vel, state.prev_hand_vel,
            state.prev_hand_ang_vel, state.prev_contacts)
        total, components = rew_mod.compute_total_reward(c.reward_cfg, common, tstep.reward_terms)
        rew = total + term_reward
        components.update(term_comps)
        consecutive = torch.where(
            self.any_rank(term_info["success"]),
            torch.clamp(state.consecutive_successes + 1,
                        max=c.term_cfg.max_consecutive_successes),
            torch.zeros_like(state.consecutive_successes))

        # --- masked auto-reset of done envs (spawn-projected reset poses) ---
        self._check_reset_vals(reset_vals)
        rdof = c.task.project_spawn(reset_vals.dof_pos)
        reset_active = action_mod.extract_active_targets(rdof)
        new_phys = PhysicsState(
            q=_where(done, rdof, phys.q),
            qd=_where(done, 0.0, phys.qd),
            box_pos=phys.box_pos if reset_vals.box_pos is None
            else _where(done, reset_vals.box_pos, phys.box_pos),
            box_quat=phys.box_quat if reset_vals.box_quat is None
            else _where(done, reset_vals.box_quat, phys.box_quat),
            box_linvel=_where(done, 0.0, phys.box_linvel),
            box_angvel=_where(done, 0.0, phys.box_angvel),
        )
        if phys.box2_pos is not None:
            new_phys.box2_pos = _where(done, reset_vals.box2_pos, phys.box2_pos)
            new_phys.box2_quat = _where(done, reset_vals.box2_quat, phys.box2_quat)
            new_phys.box2_linvel = _where(done, 0.0, phys.box2_linvel)
            new_phys.box2_angvel = _where(done, 0.0, phys.box2_angvel)
        new_dr = state.dr if dr_new is None else DRSample(*(
            _where(done, getattr(dr_new, f.name), getattr(state.dr, f.name))
            for f in dataclasses.fields(DRSample)))
        task_states = dict(tstep.task_states)
        for k, v in (reset_vals.task_states or {}).items():
            task_states[k] = _where(done, v, task_states[k])
        new_state = EnvState(
            physics=new_phys,
            full_dof_targets=_where(done, rdof, full),
            active_prev_targets=_where(done, reset_active, active),
            active_rule_targets=_where(done, reset_active, active_rule),
            prev_actions=_where(done, 0.0, actions),
            prev_dof_pos=_where(done, rdof, phys.q),
            contact_duration_steps=_where(done, 0, new_duration),
            prev_contact_binary=_where(done, 0.0, binary),
            episode_step_count=_where(done, 0, new_count),
            body_contact_force=_where(done, 0.0, info.body_contact_force),
            prev_finger_dof_vel=_where(done, 0.0, rtrack["prev_finger_dof_vel"]),
            prev_hand_vel=_where(done, 0.0, rtrack["prev_hand_vel"]),
            prev_hand_ang_vel=_where(done, 0.0, rtrack["prev_hand_ang_vel"]),
            prev_contacts=_where(done, False, rtrack["prev_contacts"]),
            success_flags={k: _where(done, False, v) for k, v in new_s.items()},
            failure_flags={k: _where(done, False, v) for k, v in new_f.items()},
            consecutive_successes=consecutive,
            task_states=task_states,
            dr=new_dr,
            difficulty=state.difficulty,
        )
        extras = {
            "consecutive_successes": consecutive,
            "episode_length": new_count,
            "reward_components": components,
            **term_info,
        }
        if "spawn_difficulty" in state.task_states:
            # the curriculum's strict gate (train.py promote_strict): episodes
            # spawned at the controller's difficulty, read from the pre-step
            # state (constant through an episode)
            strict = state.task_states["spawn_difficulty"] >= state.difficulty - 1e-4
            extras["success_strict"] = term_info["success"] & strict
            extras["done_strict"] = done & strict
        return new_state, obs_buf, rew, done, extras

    def reset_fn(self, samples=None):
        """Full reset of all envs + the initial observation. `samples` as in
        `step_fn` (reset values unprojected; DRSample or None)."""
        c = self.comps
        n, dev = c.num_envs, self.device
        difficulty = torch.tensor(c.initial_difficulty, dtype=torch.float32, device=dev)
        reset_vals, dr = samples if samples is not None else self.draw_samples(n, difficulty)
        self._check_reset_vals(reset_vals)
        dof = c.task.project_spawn(reset_vals.dof_pos)
        zeros = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=dev)
        quat = zeros(n, 4)
        quat[:, 3] = 1.0
        phys = PhysicsState(
            q=dof, qd=zeros(n, NUM_DOFS),
            box_pos=reset_vals.box_pos if reset_vals.box_pos is not None else zeros(n, 3),
            box_quat=reset_vals.box_quat if reset_vals.box_quat is not None else quat,
            box_linvel=zeros(n, 3), box_angvel=zeros(n, 3),
        )
        has_box2 = c.engine.params.has_box2
        if has_box2:
            phys.box2_pos, phys.box2_quat = reset_vals.box2_pos, reset_vals.box2_quat
            phys.box2_linvel, phys.box2_angvel = zeros(n, 3), zeros(n, 3)
        kin = c.engine.fk(phys.q, phys.qd, self._spawn.expand(n, 3))
        nc = c.obs_cfg.num_contact_bodies
        reset_active = action_mod.extract_active_targets(dof)
        state_like = {
            "prev_dof_pos": dof, "full_dof_targets": dof,
            "active_prev_targets": reset_active,
            "prev_actions": zeros(n, c.num_actions),
            "body_contact_force": zeros(n, c.model.num_bodies, 3),
            "box_contact_force": zeros(n, 3),
            "box2_contact_force": zeros(n, 3) if has_box2 else None,
            "contact_duration_steps": zeros(n, nc, dt=torch.int32),
            "prev_contact_binary": zeros(n, nc),
            "episode_step_count": zeros(n, dt=torch.int32),
        }
        task_states = c.task.init_task_states(n, dev)
        task_states.update(reset_vals.task_states or {})
        obs_dict, obs_buf, tstep, active_rule, _, _ = self._observe(
            phys, kin, state_like, task_states)
        failure_names = {*term_mod.builtin_failure_criteria(c.term_cfg, obs_dict),
                         *tstep.failure_criteria}
        state = EnvState(
            physics=phys,
            full_dof_targets=dof,
            active_prev_targets=reset_active,
            active_rule_targets=active_rule,
            prev_actions=state_like["prev_actions"],
            prev_dof_pos=dof,
            contact_duration_steps=zeros(n, nc, dt=torch.int32),
            prev_contact_binary=zeros(n, nc),
            episode_step_count=zeros(n, dt=torch.int32),
            body_contact_force=state_like["body_contact_force"],
            prev_finger_dof_vel=zeros(n, 20),
            prev_hand_vel=zeros(n, 3),
            prev_hand_ang_vel=zeros(n, 3),
            prev_contacts=zeros(n, nc, dt=torch.bool),
            success_flags={k: zeros(n, dt=torch.bool)
                           for k in c.term_cfg.active_success(tstep.success_criteria)},
            failure_flags={k: zeros(n, dt=torch.bool)
                           for k in c.term_cfg.active_failure(failure_names)},
            consecutive_successes=torch.zeros((), dtype=torch.int32, device=dev),
            task_states=tstep.task_states,
            dr=dr if dr is not None else DRSample.nominal(n, dev),
            difficulty=difficulty,
        )
        return state, obs_buf

    # ------------------------------------------------------------------
    def reset(self):
        self.state, obs = self.reset_fn()
        return obs

    def step(self, actions):
        if self.state is None:
            self.reset()
        if self._random_actions:
            actions = torch.rand(self.num_envs, self.num_actions, generator=self.generator,
                                 device=self.device) * 2 - 1
        self.state, obs, rew, done, extras = self.step_fn(self.state, actions)
        return obs, rew, done, extras

    def toggle_random_actions(self) -> bool:
        """Toggle the random-action override of `step`: uniform actions in
        [-1, 1] from the env's generator (the reference's debug key,
        dexhand_base.py:854-862)."""
        self._random_actions = not self._random_actions
        return self._random_actions

    def seed(self, seed: int) -> None:
        """Reseed the env's generator (resets and DR draws, random actions)."""
        self.generator.manual_seed(self.group.rank_seed(seed))

    def set_difficulty(self, value: float) -> None:
        """The curriculum difficulty of the wrapper's own state (a loop that
        holds its own EnvState replaces the `difficulty` leaf instead)."""
        if self.state is not None:
            self.state = dataclasses.replace(self.state, difficulty=torch.tensor(
                float(value), dtype=torch.float32, device=self.device))

    def get_obs_slice(self, key: str) -> Tuple[int, int]:
        """(start, end) of `key` within the policy observation tensor."""
        if key not in self.obs_slices:
            raise KeyError(f"'{key}' is not in policy_observation_keys "
                           f"(available: {sorted(self.obs_slices)})")
        return self.obs_slices[key]

    def get_obs_index_for_base_joint(self, joint_name: str, obs_type: str = "pos") -> int:
        """Index of a base DOF within the policy tensor."""
        key = {"pos": "base_dof_pos", "vel": "base_dof_vel", "target": "base_dof_target"}[obs_type]
        return self.get_obs_slice(key)[0] + BASE_JOINT_NAMES.index(joint_name)

    def get_obs_index_for_finger_control(self, control_index: int, obs_type: str = "pos") -> int:
        """Index of an active finger control (0-11) within the policy tensor."""
        key = {"pos": "active_finger_dof_pos", "vel": "active_finger_dof_vel",
               "target": "active_finger_dof_target"}[obs_type]
        return self.get_obs_slice(key)[0] + control_index

    @property
    def observation_space(self) -> "_Space":
        return _Space((self.num_obs,))

    @property
    def action_space(self) -> "_Space":
        return _Space((self.num_actions,), low=-1.0, high=1.0)

    def close(self) -> None:
        pass


@dataclasses.dataclass
class _Space:
    shape: Tuple[int, ...]
    low: float = -math.inf
    high: float = math.inf

"""Environment verification harness (the port of `examples/dexhand_test.py`).

    python -m dexrobot_isaac_tpu_torch.tools.dexhand_test [key=value ...]
    python -m dexrobot_isaac_tpu_torch.tools.dexhand_test task=BlindGrasping steps=40 device=cpu
    python -m dexrobot_isaac_tpu_torch.tools.dexhand_test mode=contact
    python -m dexrobot_isaac_tpu_torch.tools.dexhand_test mode=rulebased
    python -m dexrobot_isaac_tpu_torch.tools.dexhand_test videoRecord=true plot=true live=true

It builds an env (2 envs; on the card unless `device=cpu`; other `key=value`
overrides go to the config) and checks: the action space against the
control flags; through the action pipeline, in both control modes, that
each action moves exactly its coupled DOFs' targets (the 2.0 scale of
r_f_joint5_1 included, r_f_joint3_1 pinned at 0, no cross-talk) and that a
custom action rule halving the actions gives the default rule's targets at
half magnitude. Then, by `mode`:

- `sweep` (default): each action swept -1 -> +1 -> -1 over `steps` steps;
  its mapped DOFs must respond in the simulated state;
- `contact`: the hand spawned just above BlindGrasping's box and driven
  onto it; prints the steps with a fingertip contact;
- `rulebased`: the task with a pre-action rule of `circular_base_motion`
  and `adaptive_grasp` (envs/rule_based.py) and a policy that controls
  nothing (0 actions); the base must move.

Options of the sweep: `videoRecord=true` renders env 0 during the sweeps
of the first three actions into `dexhand_test_videos/episode_00001.mp4`;
`plot=true` saves env 0's reward and ARTx position over action 0's sweep
to `dexhand_test_series.png`; `live=true` serves env 0's reward, the
action magnitude, the swept DOF and its contact count as live charts at
`http://127.0.0.1:8090/` (graphics/liveplot.py; the next free port if
taken) while the sweep runs. Exit code 0 when every check passes.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.constants import (
    DOF_INDEX,
    DOF_NAMES,
    FINGER_COUPLING_MAP,
    NUM_BASE_DOFS,
    NUM_DOFS,
)
from dexrobot_isaac_tpu_torch.envs import action as action_mod
from dexrobot_isaac_tpu_torch.envs.rule_based import (
    adaptive_grasp,
    circular_base_motion,
    make_pre_action_rule,
)
from dexrobot_isaac_tpu_torch.factory import TASK_REGISTRY, make_env
from dexrobot_isaac_tpu_torch.graphics.liveplot import LivePlotServer
from dexrobot_isaac_tpu_torch.graphics.renderer import SceneRenderer, env_rows
from dexrobot_isaac_tpu_torch.graphics.video import VideoRecorder
from dexrobot_isaac_tpu_torch.utils.config import get_by_path, load_config
from dexrobot_isaac_tpu_torch.utils.logging import setup_logging

def expected_action_mapping(pcb: bool, pcf: bool) -> Dict[int, List[Tuple[int, float]]]:
    """action index -> [(DOF index, coupling scale), ...]."""
    mapping, a = {}, 0
    if pcb:
        for d in range(NUM_BASE_DOFS):
            mapping[a] = [(d, 1.0)]
            a += 1
    if pcf:
        for control in range(12):
            mapping[a] = [(DOF_INDEX[j], s) for j, s in FINGER_COUPLING_MAP[control]]
            a += 1
    return mapping


def _targets_after(pl, num_actions: int, a_idx: int, mag: float, steps: int) -> np.ndarray:
    """Full DOF targets after `steps` pipeline steps of one action held at
    `mag` (the rule starting from the previous targets)."""
    active = torch.zeros(1, 18)
    actions = torch.zeros(1, num_actions)
    actions[:, a_idx] = mag
    full = action_mod.apply_coupling(pl, active)
    for _ in range(steps):
        full, active = action_mod.process_actions(pl, actions, active, active)
    return full[0].numpy()


def verify_action_mapping(pipeline, num_actions: int, pcb: bool, pcf: bool,
                          steps: int = 40) -> List[str]:
    """Action k moves exactly its coupled DOFs' targets, at the coupling's
    scale ratios, and no other DOF's; r_f_joint3_1 stays at 0. Returns the
    failures (empty = verified)."""
    mapping = expected_action_mapping(pcb, pcf)
    j31 = DOF_INDEX["r_f_joint3_1"]
    failures = []
    for a_idx in range(num_actions):
        hi = _targets_after(pipeline, num_actions, a_idx, 0.4, steps)
        lo = _targets_after(pipeline, num_actions, a_idx, -0.4, steps)
        if abs(hi[j31]) > 1e-7 or abs(lo[j31]) > 1e-7:
            failures.append(f"action {a_idx}: r_f_joint3_1 target not pinned at 0")
        diff = hi - lo
        mapped = dict(mapping[a_idx])
        for d in range(NUM_DOFS):
            if d == j31:
                continue
            if d in mapped and abs(diff[d]) < 1e-4:
                failures.append(f"action {a_idx}: mapped DOF {DOF_NAMES[d]} did not respond "
                                f"(|diff|={abs(diff[d]):.2e})")
            elif d not in mapped and abs(diff[d]) > 1e-6:
                failures.append(f"action {a_idx}: cross-talk onto unmapped DOF {DOF_NAMES[d]} "
                                f"({diff[d]:+.2e})")
        base_d, base_s = mapping[a_idx][0]
        for d, s in mapping[a_idx][1:]:
            want = diff[base_d] * (s / base_s)
            if abs(diff[d] - want) > 1e-5 * max(1.0, abs(want)):
                failures.append(f"action {a_idx}: coupling scale mismatch on {DOF_NAMES[d]} "
                                f"(got {diff[d]:+.5f}, want {want:+.5f})")
    return failures


def verify_custom_rule_modes(pipeline, num_actions: int, steps: int = 20) -> List[str]:
    """In both control modes, a custom rule that halves the actions gives
    the default rule's targets at half magnitude."""
    failures = []
    for mode, base_rule in (("position", action_mod.position_action_rule),
                            ("position_delta", action_mod.position_delta_action_rule)):
        def half_rule(pl, prev, rule_t, actions, _base=base_rule):
            return _base(pl, prev, rule_t, actions * 0.5)

        pl_base = dataclasses.replace(pipeline, control_mode=mode, custom_action_rule=None)
        pl_half = dataclasses.replace(pipeline, control_mode=mode, custom_action_rule=half_rule)
        for a_idx in (0, num_actions - 1):
            got = _targets_after(pl_half, num_actions, a_idx, 0.8, steps)
            want = _targets_after(pl_base, num_actions, a_idx, 0.4, steps)
            if not np.allclose(got, want, rtol=0, atol=1e-7):
                failures.append(f"{mode}: custom half-rule != default at half magnitude "
                                f"(action {a_idx}, max err {np.abs(got - want).max():.2e})")
    return failures


def rule_based_task(task_name: str):
    """`task_name`'s task with the harness's pre-action rule (a 5 cm circle
    of the base every 2 s, fingers closing until contact), registered in the
    factory as `<task_name>RuleBased`; returns that name."""
    name = f"{task_name}RuleBased"
    if name not in TASK_REGISTRY:
        TASK_REGISTRY[name] = type(name, (TASK_REGISTRY[task_name],), {
            "pre_action_rule": staticmethod(make_pre_action_rule(
                base_controller=circular_base_motion(radius=0.05, period=2.0),
                finger_controller=adaptive_grasp()))})
    return name


def rule_based_config(cfg):
    """`cfg` with its task swapped for `rule_based_task`'s and the policy
    controlling neither the base nor the fingers (0 actions)."""
    cfg["task"]["name"] = rule_based_task(cfg["task"].get("name", "BaseTask"))
    cfg["task"]["policy_controls_hand_base"] = False
    cfg["task"]["policy_controls_fingers"] = False
    return cfg


def run_contact_test(cfg, steps: int, device, logger) -> int:
    """The hand driven onto the box (down, three finger controls closing);
    reports the steps with a fingertip contact (the reference harness's
    ContactTestTask, examples/dexhand_test.py:950-1028)."""
    env = make_env(cfg, device=device)
    env.reset()
    start, end = env.get_obs_slice("contact_binary")
    hit_steps = 0
    for _ in range(steps):
        a = torch.zeros(env.num_envs, env.num_actions, device=env.device)
        a[:, 2] = -1.0
        a[:, [7, 9, 11]] = 0.5
        obs, _, _, _ = env.step(a)
        hit_steps += bool(obs[0, start:end].any())
    logger.info(f"Contact exercise: contact observed on {hit_steps}/{steps} steps")
    if hit_steps == 0:
        logger.warning("No contacts observed: check the box placement and the steps")
    return 0


def run_rule_based_test(cfg, steps: int, device, logger) -> int:
    """The rule-based controllers drive the hand with 0 policy actions; the
    base must move by more than 1 mm in env 0."""
    env = make_env(rule_based_config(cfg), device=device)
    env.reset()
    xs = []
    for _ in range(steps):
        env.step(torch.zeros(env.num_envs, env.num_actions, device=env.device))
        xs.append(float(env.state.physics.q[0, 0]))
    moved = max(xs) - min(xs)
    logger.info(f"Rule-based base motion amplitude over {steps} steps: {moved:.4f} m")
    if moved < 1e-3:
        logger.error("Rule-based base controller produced no motion")
        return 1
    logger.info("Rule-based control verification PASSED")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    steps, mode, device, plot, live, keep = 30, "sweep", "cuda", False, False, []
    for a in argv:
        key, _, val = a.partition("=")
        if key == "steps":
            steps = int(val)
        elif key == "mode":
            mode = val
        elif key == "device":
            device = val
        elif key == "plot":
            plot = val.lower() in ("1", "true", "yes")
        elif key == "live":
            live = val.lower() in ("1", "true", "yes")
        else:
            keep.append(a)

    cfg = load_config(keep + ["numEnvs=2"])
    logger = setup_logging(get_by_path(cfg, "train.logging.logLevel", "info"))
    env = make_env(cfg, device=device)
    logger.info(f"Env built: task={get_by_path(cfg, 'task.name')} num_obs={env.num_obs} "
                f"num_actions={env.num_actions} device={env.device}")
    pcb = bool(get_by_path(cfg, "task.policy_controls_hand_base", True))
    pcf = bool(get_by_path(cfg, "task.policy_controls_fingers", True))
    if env.num_actions != 6 * pcb + 12 * pcf:
        logger.error(f"action space {env.num_actions} != expected {6 * pcb + 12 * pcf}")
        return 1
    logger.info(f"Action-space check OK ({env.num_actions})")

    failures = []
    for mode_name in ("position", "position_delta"):
        pl = dataclasses.replace(env.comps.pipeline, control_mode=mode_name,
                                 custom_action_rule=None)
        f = verify_action_mapping(pl, env.num_actions, pcb, pcf)
        failures += [f"[{mode_name}] {x}" for x in f]
        logger.info(f"Mapped-DOF verification ({mode_name}): "
                    f"{'OK' if not f else f'{len(f)} FAILURES'}")
    rule_failures = verify_custom_rule_modes(env.comps.pipeline, env.num_actions)
    logger.info("Custom-rule verification (both modes): "
                + ("OK" if not rule_failures else f"{len(rule_failures)} FAILURES"))
    if failures or rule_failures:
        for x in failures + rule_failures:
            logger.error(x)
        return 1

    if mode == "contact":
        # the hand spawned just above the box: contacts within a few dozen
        # steps even at the task's 0.1 m/s base velocity limit
        cfg = load_config(keep + ["numEnvs=2", "task=BlindGrasping",
                                  "env.initialHandPos=[0.0, 0.0, 0.10]"])
        return run_contact_test(cfg, max(steps, 60), device, logger)
    if mode == "rulebased":
        return run_rule_based_test(cfg, max(steps, 40), device, logger)

    recorder = renderer = liveplot = None
    if get_by_path(cfg, "env.videoRecord", False):
        renderer = SceneRenderer(env.comps.model)
        recorder = VideoRecorder("dexhand_test_videos")
        recorder.finalize_fps(env.control_dt)
        recorder.start_episode()
    if live:
        liveplot = LivePlotServer()
        liveplot.start()
        logger.info(f"Live charts: http://127.0.0.1:{liveplot.port}/")
    series = {"reward": [], "dof": []} if plot else None

    # the action-to-DOF sweep: each action's mapped DOFs respond in the
    # simulated state
    mapping = expected_action_mapping(pcb, pcf)
    j31 = DOF_INDEX["r_f_joint3_1"]
    weak_actions = []
    for a_idx in range(env.num_actions):
        env.reset()
        base_q = env.state.physics.q[0].cpu().numpy().copy()
        dev = np.zeros_like(base_q)
        for t in range(steps):
            phase = t / max(steps - 1, 1)
            mag = (1.0 - abs(2 * phase - 1.0)) * 2 - 1.0  # -1 -> +1 -> -1
            actions = torch.zeros(env.num_envs, env.num_actions, device=env.device)
            actions[:, a_idx] = mag
            _, rew, _, _ = env.step(actions)
            q0 = env.state.physics.q[0].cpu().numpy()
            if series is not None and a_idx == 0:
                series["reward"].append(float(rew[0]))
                series["dof"].append(float(q0[0]))
            if liveplot is not None:
                liveplot.log_many({
                    "reward (env 0)": float(rew[0]),
                    "action magnitude": float(mag),
                    f"q[{a_idx}] sweep DOF": float(q0[mapping[a_idx][0][0]]),
                    "contacts (env 0)": float(env.state.prev_contact_binary[0].sum()),
                })
            dev = np.maximum(dev, np.abs(q0 - base_q))
            if recorder is not None and a_idx < 3:
                rows = env_rows(env.comps.engine, env.state.physics, env._spawn, None, 0)
                recorder.add_frame(renderer.render_state(
                    rows.body_pos, rows.body_quat,
                    box_pos=rows.box_pos if env.comps.engine.params.has_box else None,
                    box_quat=rows.box_quat, title=f"action {a_idx} t={t}"))
        weak = [DOF_NAMES[d] for d, _ in mapping[a_idx] if d != j31 and dev[d] < 5e-4]
        if weak:
            weak_actions.append(a_idx)
            logger.warning(f"action {a_idx}: mapped DOFs with no physics response: {weak}")
        else:
            logger.info(f"action {a_idx}: mapped-DOF response OK (min dev "
                        f"{min(dev[d] for d, _ in mapping[a_idx] if d != j31):.4f})")
    if recorder is not None:
        recorder.stop_episode()
        recorder.close()
        renderer.close()
    if liveplot is not None:
        liveplot.stop()
    if series is not None and series["reward"]:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(8, 6))
        axes[0].plot(series["reward"])
        axes[0].set_title("reward (env 0, action 0 sweep)")
        axes[1].plot(series["dof"])
        axes[1].set_title("ARTx position")
        fig.tight_layout()
        fig.savefig("dexhand_test_series.png", dpi=100)
        plt.close(fig)
        logger.info("Saved dexhand_test_series.png")
    if weak_actions:
        logger.error(f"Actions with no DOF response: {weak_actions}")
        return 1
    logger.info("All actions drive DOFs: verification PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())

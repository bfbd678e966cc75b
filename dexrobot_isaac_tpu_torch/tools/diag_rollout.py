"""Diagnostic rollout: a checkpoint's deterministic policy on the unfused
step, its terminations counted by criterion, with task-state summaries (the
port of `tools/diag_rollout.py`).

    python -m dexrobot_isaac_tpu_torch.tools.diag_rollout <ckpt> [task] [difficulty]
        [num_envs] [steps] [device=cpu]

`<ckpt>` is a checkpoint of either format (a port `.pt` or a JAX package
`.ckpt`), a run directory or `latest`. It runs `num_envs` envs (default 8)
for `steps` control steps (default 600) at the given curriculum difficulty
(default 1.0; attributing training-time failures needs the training
difficulty, not evaluation's 1.0), on the card (K2 steps the physics) unless
`device=cpu`. The run's saved `config.json`, where the checkpoint sits in a
run directory, is used in place of the task's defaults, so experiment
overlays (network, critic keys) match the checkpoint. It prints the episodes
ended by each success and failure criterion, each failure criterion's share
of the envs every 100 steps, and per task the state one step before a
failure: BlindGrasping's hitting_ground (the lowest fingertip, the box, the
stage) and stage-1 pre-grasp checks, BoxStacking's platform drift and the
closest stack distance.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.rl.checkpoint import load_checkpoint
from dexrobot_isaac_tpu_torch.rl.ppo import PPOLearner, ppo_config_from
from dexrobot_isaac_tpu_torch.utils.config import load_config, set_by_path
from dexrobot_isaac_tpu_torch.utils.device import resolve_device
from dexrobot_isaac_tpu_torch.utils.experiment import resolve_checkpoint

FINGERS = ["thumb", "index", "middle", "ring", "pinky"]


def _pct(a) -> str:
    a = np.asarray(a, np.float64)
    return " ".join(f"p{q}={np.percentile(a, q):.3f}" for q in (10, 50, 90))


def _config(ckpt: str, task: str, n: int, device: str):
    """The run's saved config where the checkpoint sits in a run directory
    (`<run>/nn/<file>`), else the task's defaults."""
    saved = os.path.join(os.path.dirname(os.path.dirname(ckpt)), "config.json")
    if os.path.exists(saved):
        with open(saved) as f:
            cfg = json.load(f)
        print(f"using run config {saved}")
    else:
        cfg = load_config([f"task={task}"])
    set_by_path(cfg, "env.numEnvs", n)
    set_by_path(cfg, "device", device)
    return cfg


def run(ckpt_spec: str, task: str = "BoxStacking", difficulty: float = 1.0, n: int = 8,
        steps: int = 600, device: str = "cuda") -> Dict[str, int]:
    """The rollout; prints the summaries and returns the episodes ended by
    each criterion (`success_reason_*`, `failure_reason_*`) and `episodes`."""
    dev = resolve_device(device)
    ckpt = resolve_checkpoint(ckpt_spec)
    cfg = _config(ckpt, task, n, dev.type)
    task = cfg["task"].get("name", task)
    env = make_env(cfg, seed=7, device=dev)
    env.comps.initial_difficulty = difficulty
    learner = PPOLearner(ppo_config_from(cfg, env), env.step_fn, seed=0, device=dev)
    ppo = load_checkpoint(ckpt, learner.init_state())
    print(f"loaded {ckpt}; task={task} difficulty={difficulty} envs={n} device={dev}")
    state, obs = env.reset_fn()
    c = env.comps
    spawn = env._spawn.expand(n, 3)
    host = lambda x: x.detach().cpu().numpy()

    counts: Dict[str, int] = {"episodes": 0}
    bg: Dict[str, List] = {k: [] for k in ("tip_z", "tip_id", "n_tips_under", "tip_box_xy",
                                           "box_z", "box_max_z", "hand_z", "step", "stage")}
    pg: Dict[str, List] = {k: [] for k in ("height", "centroid", "drift", "speed",
                                           "hand_box_xy")}
    pm: Dict[str, List] = {k: [] for k in ("drift", "radial", "cube_plat_xy", "cube_z",
                                           "hand_plat_xy", "step")}
    box_peak = np.zeros(n)
    min_stack = np.full(n, 1e9)
    tip_idx = list(c.obs_cfg.fingertip_site_indices)
    pad_idx = list(c.obs_cfg.fingerpad_site_indices)
    tip_thresh = float(c.term_cfg.fingertip_threshold)
    for t in range(steps):
        # the state handed INTO the step: within one control step of a
        # failure it reports (the returned state is already reset)
        ph, ts = state.physics, state.task_states
        snap_box, snap_count = host(ph.box_pos), host(state.episode_step_count)
        hand_xy = host(ph.q[:, :2] + spawn[:, :2])
        if task == "BlindGrasping":
            kin = c.engine.fk(ph.q, ph.qd, spawn)
            snap_tips, snap_pads = host(kin.site_pos[:, tip_idx]), host(kin.site_pos[:, pad_idx])
            snap_boxv, snap_box0 = host(ph.box_linvel), host(ts["initial_box_pos"])
            snap_stage, snap_handz = host(ts["current_stage"]), host(ph.q[:, 2] + spawn[:, 2])
            box_peak = np.maximum(box_peak, snap_box[:, 2])
        if task == "BoxStacking":
            snap_plat, snap_spawn = host(ph.box2_pos[:, :2]), host(ts["platform_spawn_xy"])
        actions = learner.act_deterministic(ppo, obs)
        state, obs, rew, done, extras = env.step_fn(state, actions)
        done_h = host(done)
        flag = lambda name: host(extras[name]) & done_h if name in extras else done_h & False
        if task == "BlindGrasping":
            sel = flag("failure_reason_hitting_ground")
            if sel.any():
                tz = snap_tips[sel][:, :, 2]
                low = tz.argmin(axis=1)
                k = np.arange(len(low))
                bg["tip_z"] += list(tz[k, low])
                bg["tip_id"] += list(low)
                bg["n_tips_under"] += list((tz < tip_thresh).sum(axis=1))
                bg["tip_box_xy"] += list(np.linalg.norm(
                    snap_tips[sel][k, low, :2] - snap_box[sel, :2], axis=1))
                bg["box_z"] += list(snap_box[sel, 2])
                bg["box_max_z"] += list(box_peak[sel])
                bg["hand_z"] += list(snap_handz[sel])
                bg["step"] += list(snap_count[sel])
                bg["stage"] += list(snap_stage[sel])
            sel = flag("failure_reason_stage1_pregrasp_failed")
            if sel.any():
                pads3, bx = snap_pads[sel][:, :3, :], snap_box[sel]
                pg["height"] += list(np.abs(pads3[:, :, 2] - bx[:, None, 2]).max(axis=1))
                pg["centroid"] += list(np.linalg.norm(pads3.mean(axis=1) - bx, axis=1))
                pg["drift"] += list(np.linalg.norm(bx - snap_box0[sel], axis=1))
                pg["speed"] += list(np.linalg.norm(snap_boxv[sel], axis=1))
                pg["hand_box_xy"] += list(np.linalg.norm(hand_xy[sel] - bx[:, :2], axis=1))
            box_peak[done_h] = 0.0
        if task == "BoxStacking":
            sel = flag("failure_reason_platform_moved")
            if sel.any():
                v = snap_plat[sel] - snap_spawn[sel]
                sp = snap_spawn[sel]
                spn = sp / np.maximum(np.linalg.norm(sp, axis=1, keepdims=True), 1e-9)
                pm["drift"] += list(np.linalg.norm(v, axis=1))
                pm["radial"] += list((v * spn).sum(axis=1))
                pm["cube_plat_xy"] += list(np.linalg.norm(snap_box[sel, :2] - snap_plat[sel],
                                                          axis=1))
                pm["cube_z"] += list(snap_box[sel, 2])
                pm["hand_plat_xy"] += list(np.linalg.norm(hand_xy[sel] - snap_plat[sel], axis=1))
                pm["step"] += list(snap_count[sel])
            ph2, t2 = state.physics, env.comps.task
            d = torch.cat([ph2.box_pos[:, :2] - ph2.box2_pos[:, :2],
                           ph2.box_pos[:, 2:3] - ph2.box2_pos[:, 2:3]
                           - (t2.plat_size + t2.box_size) / 2], 1)
            min_stack = np.minimum(min_stack, host(torch.linalg.vector_norm(d, dim=1)))
        if done_h.any():
            counts["episodes"] += int(done_h.sum())
            for k, v in extras.items():
                if k.startswith(("success_reason_", "failure_reason_")):
                    counts[k] = counts.get(k, 0) + int((host(v) & done_h).sum())
        if t % 100 == 0:
            rates = {k[len("failure_reason_"):]: float(host(v).mean())
                     for k, v in extras.items() if k.startswith("failure_reason_")}
            print(f"t={t} failure-criterion shares {rates}")

    episodes = counts["episodes"]
    print(f"\nepisodes finished: {episodes}")
    for k, v in sorted(counts.items()):
        if k != "episodes":
            print(f"  {k}: {v} ({v / max(1, episodes):.3f}/episode)")
    if bg["tip_z"]:
        tid = np.asarray(bg["tip_id"])
        stg = np.asarray(bg["stage"])
        print(f"\nhitting_ground ({len(tid)} failures, the state one step before; fingertip "
              f"threshold {tip_thresh:+.3f}):")
        print(f"  lowest tip z (m):            {_pct(bg['tip_z'])}")
        print(f"  lowest-tip finger histogram: "
              f"{ {FINGERS[i]: int((tid == i).sum()) for i in range(5)} }")
        print(f"  tips under threshold:        {_pct(bg['n_tips_under'])}")
        print(f"  lowest-tip to box XY (m):    {_pct(bg['tip_box_xy'])}")
        print(f"  box z at failure (m):        {_pct(bg['box_z'])}")
        print(f"  box peak z this episode (m): {_pct(bg['box_max_z'])}")
        print(f"  share with peak box z > 0.15 (drop and regrasp): "
              f"{(np.asarray(bg['box_max_z']) > 0.15).mean():.3f}")
        print(f"  hand base z (m):             {_pct(bg['hand_z'])}")
        print(f"  episode step at failure:     {_pct(bg['step'])}")
        print(f"  stage histogram:             "
              f"{ {int(s): int((stg == s).sum()) for s in np.unique(stg)} }")
    if pg["height"]:
        print(f"\nstage1_pregrasp ({len(pg['height'])} failures, the state one step before "
              "the transition):")
        print("  condition failed: "
              f"height(>3cm)={np.mean(np.asarray(pg['height']) > 0.03):.2f} "
              f"centroid(>8cm)={np.mean(np.asarray(pg['centroid']) > 0.08):.2f} "
              f"drift(>1cm)={np.mean(np.asarray(pg['drift']) > 0.01):.2f} "
              f"box_vel(>5mm/s)={np.mean(np.asarray(pg['speed']) > 0.005):.2f}")
        print(f"  box speed (m/s):             {_pct(pg['speed'])}")
        print(f"  max pad-box height diff (m): {_pct(pg['height'])}")
        print(f"  pad centroid to box (m):     {_pct(pg['centroid'])}")
        print(f"  box drift from spawn (m):    {_pct(pg['drift'])}")
        print(f"  hand-box XY distance (m):    {_pct(pg['hand_box_xy'])}")
    if task == "BoxStacking":
        print(f"closest stack distance over the run (m): {_pct(min_stack)}")
        if pm["drift"]:
            print(f"\nplatform_moved ({len(pm['drift'])} failures, the state one step before):")
            print(f"  platform drift (m):          {_pct(pm['drift'])}")
            print(f"  radial drift (+away, m):     {_pct(pm['radial'])}")
            print(f"  cube-platform XY (m):        {_pct(pm['cube_plat_xy'])}")
            print(f"  cube z (m):                  {_pct(pm['cube_z'])}")
            print(f"  hand base-platform XY (m):   {_pct(pm['hand_plat_xy'])}")
            print(f"  episode step at failure:     {_pct(pm['step'])}")
    return counts


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    pos = []
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            pos.append(a)
    if not pos:
        print(__doc__)
        return 2
    run(pos[0], pos[1] if len(pos) > 1 else "BoxStacking",
        float(pos[2]) if len(pos) > 2 else 1.0, int(pos[3]) if len(pos) > 3 else 8,
        int(pos[4]) if len(pos) > 4 else 600, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI entry point of the torch port: train or evaluate PPO policies.

The port of the repository's `train.py`, over the port's JSON config twins:

    python -m dexrobot_isaac_tpu_torch.train task=BlindGrasping numEnvs=4096
    python -m dexrobot_isaac_tpu_torch.train task=BlindGrasping numEnvs=4 maxIterations=2 device=cpu
    python -m dexrobot_isaac_tpu_torch.train test=true checkpoint=latest task=BlindGrasping
    python -m dexrobot_isaac_tpu_torch.train task=BoxStacking numEnvs=4096

`key=value` overrides, config groups and aliases as `train.py`. It runs on
the CUDA card (the config's `device`, whatever it names, unless it is
`cpu`; `device=cpu` runs the plain versions on the CPU). Each run gets a
directory under `$DEXHAND_RUNS_DIR` (default: the working directory) with
its config, log, TensorBoard events (when `tensorboard` is installed) and
checkpoints (`nn/*.pt`, rl/checkpoint.py); `checkpoint=latest|<run>|<path>`
resumes or evaluates.

`train.params.config.fused` = auto (default) | on | off: auto runs the fused
env-step kernel K1 on the card where the configuration has one (else the
unfused step) and the unfused step on the CPU; on forces the fused step on
either device (its plain version on the CPU) and raises where it is
unsupported; off runs the unfused step. `test=true` always runs the unfused
step. `train.profile=N` traces iterations 2 to 1+N with torch.profiler (CPU
and, on the card, CUDA activities) into `<run_dir>/profile/trace.json`, a
Chrome trace.

Evaluation drives the graphics sidecar (graphics/), which draws env 0's
state (the viewer's selected env) on the host after each step:
`env.videoRecord=true` writes mp4 files to `env.video.outputDir` (default
`<run_dir>/videos`), `env.videoStream=true` serves MJPEG at
`http://<env.stream.host>:<env.stream.port>/` (8080, the next free port if
taken), and `env.viewer=true` adds the interactive viewer (keys ENTER, F,
UP/DOWN, E resets the selected env, SPACE toggles random actions, C; from
a matplotlib window, or from the stream's page) and paces the loop to
`control_dt`. Training reads none of the three.

Training on several cards takes one process per card:

    torchrun --nproc_per_node=N -m dexrobot_isaac_tpu_torch.train task=BlindGrasping numEnvs=8192

(a manual launch sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK in each process itself). Rank r trains on `cuda:LOCAL_RANK` with
its contiguous share of `numEnvs`, which must divide by the number of
ranks, and the learner's collectives run over NCCL (gloo under
`device=cpu`). Rank 0 alone writes the run directory, the log file,
TensorBoard and the checkpoints. Evaluation (`test=true`) is
single-process: it refuses a launch with WORLD_SIZE > 1. A plain launch on a
host with several cards trains on one and says so.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
from dexrobot_isaac_tpu_torch.envs.types import EnvState
from dexrobot_isaac_tpu_torch.graphics.renderer import SceneRenderer, env_rows
from dexrobot_isaac_tpu_torch.graphics.streamer import HTTPVideoStreamer
from dexrobot_isaac_tpu_torch.graphics.video import VideoRecorder
from dexrobot_isaac_tpu_torch.graphics.viewer import ViewerController
from dexrobot_isaac_tpu_torch.parallel.distributed import make_sharded_env
from dexrobot_isaac_tpu_torch.parallel.mesh import Group, init_distributed, launched_world_size
from dexrobot_isaac_tpu_torch.rl.checkpoint import (
    HotReloadMonitor,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from dexrobot_isaac_tpu_torch.rl.observer import DeviceBreakdown, RewardComponentObserver
from dexrobot_isaac_tpu_torch.rl.ppo import PPOLearner, ppo_config_from
from dexrobot_isaac_tpu_torch.utils.config import ALIASES, get_by_path, load_config
from dexrobot_isaac_tpu_torch.utils.device import resolve_device
from dexrobot_isaac_tpu_torch.utils.experiment import ExperimentManager, resolve_checkpoint
from dexrobot_isaac_tpu_torch.utils.logging import setup_logging

@dataclasses.dataclass
class CliRun:
    """What `main` builds before it trains or evaluates."""

    cfg: Dict[str, Any]
    env: Any
    fused: Any                 # the fused step (envs/fused_step.py) or None
    learner: PPOLearner
    ppo: Any
    run_dir: str               # rank 0's run; never made on another rank
    logger: Any
    test_mode: bool
    group: Group
    resume_meta: Optional[Dict[str, Any]] = None
    # one entry per logged train iteration: env-steps/s of the window (over
    # all ranks), the last iteration's rollout and update seconds, its KL,
    # mean reward and the curriculum difficulty after it
    stats: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def cli_device(cfg) -> torch.device:
    """`device=cpu` runs on the CPU; anything else on the CUDA card."""
    name = str(cfg.get("device", "cuda")).lower()
    return resolve_device("cpu" if name.startswith("cpu") else "cuda")


def _fused_mode(raw) -> str:
    # YAML parses bare off/on as booleans
    mode = {False: "off", True: "on"}.get(raw, str(raw).lower())
    return {"false": "off", "0": "off", "true": "on", "1": "on"}.get(mode, mode)


def choose_fused_step(env, mode: str, device: torch.device, logger):
    """The fused step for training, or None for the unfused one: `on` builds
    it (raising FusedUnsupported where the configuration has none), `auto`
    builds it on the card and falls back where it is unsupported (a task
    without a K1 build, Coriolis terms, rows past K1's staging), `off`
    declines it."""
    if mode == "off" or (mode == "auto" and device.type != "cuda"):
        return None
    try:
        return env.make_fused()
    except FusedUnsupported as e:
        if mode == "on":
            raise
        logger.info(f"Fused env-step unavailable ({e}); unfused step")
        return None


class Profiler:
    """`train.profile=N`: a torch.profiler trace of iterations 2 to 1+N (it
    starts after one executed iteration, so first-call costs stay out),
    written to `<out_dir>/trace.json` when it stops."""

    def __init__(self, iters: int, out_dir: str, device: torch.device, logger):
        self.iters, self.out_dir, self.device, self.logger = iters, out_dir, device, logger
        self.prof, self.start = None, 0

    def before(self, it_prev: int) -> None:
        """Called before each dispatch; `it_prev` iterations have run."""
        if self.iters and self.prof is None and it_prev >= 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self.prof, self.start = profile(activities=acts), it_prev
            self.prof.start()
        elif self.prof is not None and it_prev >= self.start + self.iters:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof, self.iters = None, 0
        self.logger.info(f"Profiler trace written to {path}")


def usage_text() -> str:
    lines = [__doc__.strip(), "", "Aliases:"]
    lines += [f"  {alias:16} -> {path}" for alias, path in ALIASES.items()]
    return "\n".join(lines)


def build(cfg: Dict[str, Any]) -> CliRun:
    test_mode = bool(get_by_path(cfg, "train.test", False))
    if test_mode and launched_world_size() > 1:
        raise RuntimeError("test=true is single-process: launch evaluation without torchrun "
                           f"(WORLD_SIZE={launched_world_size()})")
    group = init_distributed(cli_device(cfg))
    device = group.device
    mode = "test" if test_mode else "train"
    task_name = get_by_path(cfg, "task.name", "BaseTask")
    runs_base = os.environ.get("DEXHAND_RUNS_DIR", ".")
    # the run directory, log file, TensorBoard and checkpoints are rank 0's;
    # another rank writes nothing, and its run_dir is a name that is never
    # made
    if group.is_main:
        exp = ExperimentManager(
            base_dir=runs_base,
            max_train_runs=int(get_by_path(cfg, "train.experiment.maxTrainRuns", 10)),
            max_test_runs=int(get_by_path(cfg, "train.experiment.maxTestRuns", 10)),
        )
        run_dir = exp.create_run(task_name, mode,
                                 experiment_name=get_by_path(cfg, "train.logging.experimentName"),
                                 cfg=cfg)
    else:
        run_dir = os.path.join(tempfile.gettempdir(), f"dexhand_rank{group.rank}")
    log_file = (None if get_by_path(cfg, "train.logging.noLogFile", False) or not group.is_main
                else os.path.join(run_dir, f"{mode}.log"))
    logger = setup_logging(get_by_path(cfg, "train.logging.logLevel", "info"), log_file)
    logger.info(f"Run directory: {run_dir}")
    logger.info(f"Task: {task_name} | mode: {mode} | device: "
                + (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"))
    if group.active:
        logger.info(f"Distributed: rank {group.rank} of {group.world_size} ({group.backend}, "
                    f"{device})")
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        logger.info(f"{n} CUDA cards visible; this run trains on one. Train on all {n} with "
                    f"torchrun --nproc_per_node={n} -m dexrobot_isaac_tpu_torch.train ...")

    seed = int(get_by_path(cfg, "train.seed", 42))
    env = make_sharded_env(cfg, group, seed=seed)
    logger.info(f"Env: {env.num_envs} envs"
                + (f" of {env.num_envs * group.world_size} on this rank" if group.active else "")
                + f", obs {env.num_obs}"
                + (f" (+{env.num_states} critic states)" if env.num_states else "")
                + f", actions {env.num_actions}, control_dt {env.control_dt:.3f}s")
    mode_f = _fused_mode(get_by_path(cfg, "train.params.config.fused", "auto"))
    fused = None if test_mode else choose_fused_step(env, mode_f, device, logger)
    learner = PPOLearner(ppo_config_from(cfg, env), fused.step_fn if fused else env.step_fn,
                         seed=seed, device=device, group=group)
    if fused is not None:
        learner.comp_names = fused.comp_names
        logger.info("Fused env-step kernel enabled")
    ppo = learner.init_state()
    resume_meta = None
    spec = get_by_path(cfg, "train.checkpoint")
    if spec:
        path = resolve_checkpoint(str(spec), base_dir=runs_base)
        logger.info(f"Loading checkpoint: {path}")
        ppo = load_checkpoint(path, ppo, learner)
        resume_meta = load_checkpoint_meta(path)
    ppo = learner.broadcast_state(ppo)
    return CliRun(cfg, env, fused, learner, ppo, run_dir, logger, test_mode, group, resume_meta)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("--help", "-h", "help") for a in argv):
        print(usage_text())
        return 0
    s = build(load_config(argv))
    try:
        return run_test(s) if s.test_mode else run_train(s)
    finally:
        s.group.close()


def run_train(s: CliRun) -> int:
    cfg, env, learner, logger = s.cfg, s.env, s.learner, s.logger
    ppo, main_rank = s.ppo, s.group.is_main
    writer = None
    if main_rank:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            writer = SummaryWriter(os.path.join(s.run_dir, "tb"))
    observer = RewardComponentObserver(
        writer, int(get_by_path(cfg, "train.logging.rewardLogInterval", 100)))
    max_iters = int(get_by_path(cfg, "train.maxIterations", 10000))
    save_freq = int(get_by_path(cfg, "train.params.config.save_frequency", 100))
    log_interval = max(1, int(get_by_path(cfg, "train.params.config.log_interval", 10)))
    task_name = get_by_path(cfg, "task.name", "BaseTask")
    nn_dir = os.path.join(s.run_dir, "nn")
    # dispatch chunking: `chunk` iterations between host syncs
    chunk = max(1, int(get_by_path(cfg, "train.params.config.dispatch_chunk", 1)))
    if chunk > 1 and max_iters % chunk:
        max_iters = (max_iters // chunk + 1) * chunk
        logger.info(f"maxIterations rounded up to {max_iters} (multiple of "
                    f"dispatch_chunk={chunk})")
    train_step = learner.make_chunked_train_step(chunk) if chunk > 1 else learner.train_iteration
    env_state, obs = s.fused.reset() if s.fused is not None else env.reset_fn()

    best_reward = -np.inf
    window_t, window_it = time.time(), 0
    steps_per_iter = learner.cfg.batch_size  # over all ranks

    # curriculum controller: promote the reset difficulty when the windowed
    # success rate clears the threshold (a host-side replacement of the
    # state's difficulty scalar), as train.py
    cur_cfg = get_by_path(cfg, "task.curriculum", {}) or {}
    cur_enabled = bool(cur_cfg.get("enabled", False))
    difficulty = float(cur_cfg.get("initial_difficulty", 0.0)) if cur_enabled else 1.0

    def with_difficulty(state, d):
        return dataclasses.replace(state, difficulty=torch.tensor(
            d, dtype=torch.float32, device=learner.device))

    if cur_enabled and s.resume_meta and "difficulty" in s.resume_meta:
        difficulty = float(s.resume_meta["difficulty"])
        env_state = with_difficulty(env_state, difficulty)
        logger.info(f"Resumed curriculum difficulty: {difficulty:.2f}")
    cur_inc = float(cur_cfg.get("increment", 0.15))
    cur_thresh = float(cur_cfg.get("promote_success_rate", 0.3))
    cur_min_episodes = int(cur_cfg.get("min_episodes", 500))
    # eval-matched gating on episodes spawned at the current difficulty
    # (tasks that report spawn_difficulty)
    cur_strict = bool(cur_cfg.get("promote_strict", False))
    cur_succ = cur_done = cur_nonstrict_done = 0
    # promotion cooldown: episodes spawned before a promotion can run
    # ceil(episodeLength / horizon) more iterations
    cur_cooldown_iters = (int(get_by_path(cfg, "env.episodeLength", 500))
                          + learner.cfg.horizon_length - 1) // learner.cfg.horizon_length + 1
    cur_cooldown_until = 0
    breakdown = None
    profiler = Profiler(int(get_by_path(cfg, "train.profile", 0) or 0) if main_rank else 0,
                        os.path.join(s.run_dir, "profile"), learner.device, logger)

    for it_prev in range(0, max_iters, chunk):
        it = min(it_prev + chunk, max_iters)

        def crossed(interval):
            return it_prev // interval != it // interval

        profiler.before(it_prev)
        ppo, env_state, obs, metrics, roll_extras = train_step(ppo, env_state, obs)
        s.ppo = ppo
        if breakdown is None:
            breakdown = DeviceBreakdown.create(roll_extras, comp_names=learner.comp_names,
                                               group=learner.group)
        breakdown.update(roll_extras)
        if crossed(log_interval) or it == max_iters:
            m = {k: float(v) for k, v in metrics.items()}
            if not (np.isfinite(m["reward_mean"]) and np.isfinite(m["kl"])):
                # outside nn/ so checkpoint=latest never resolves to it
                profiler.stop()
                if main_rank:
                    save_checkpoint(os.path.join(s.run_dir, "diverged.pt"), ppo,
                                    {"iteration": it, "difficulty": difficulty}, learner)
                logger.error(f"Non-finite training metrics at iter {it} (reward_mean="
                             f"{m['reward_mean']}, kl={m['kl']}): aborting. Resume from the "
                             "last finite checkpoint with a lower "
                             "train.params.config.lr_ceiling.")
                return 1
            now = time.time()
            sps = (it - window_it) * steps_per_iter / max(now - window_t, 1e-9)
            window_t, window_it = now, it
            rollout_s, update_s = learner.iteration_seconds()
            stats = {"iteration": it, "env_steps_per_s": sps, "rollout_s": rollout_s,
                     "update_s": update_s, "kl": m["kl"], "reward_mean": m["reward_mean"]}
            s.stats.append(stats)
            logger.info(f"iter {it}/{max_iters} reward {m['reward_mean']:+.3f} "
                        f"kl {m['kl']:.4f} lr {m['lr']:.2e} | {sps:,.0f} env-steps/s | "
                        f"rollout {rollout_s * 1e3:.1f} ms update {update_s * 1e3:.1f} ms"
                        + (f" | difficulty {difficulty:.2f}" if cur_enabled else ""))
            if writer:
                step = it * steps_per_iter
                for k, v in m.items():
                    writer.add_scalar(f"training/{k}", v, step)
                writer.add_scalar("performance/env_steps_per_s", sps, step)
                if cur_enabled:
                    writer.add_scalar("training/difficulty", difficulty, step)
            summary = breakdown.fetch_and_reset(global_step=it * steps_per_iter)
            observer.process_device_window(summary)

            if cur_enabled and difficulty < 1.0:
                ep_count = np.asarray(summary["ep_count"])
                if it < cur_cooldown_until:
                    pass  # episodes still spawned at the previous difficulty
                elif cur_strict:
                    strict = np.asarray(summary.get("ep_count_strict", [0, 0]))
                    cur_succ += int(strict[0])
                    cur_done += int(strict[1])
                    cur_nonstrict_done += int(ep_count.sum())
                    if cur_done == 0 and cur_nonstrict_done >= 4 * cur_min_episodes:
                        # without spawn_difficulty the strict counters stay
                        # zero and the curriculum would never promote
                        logger.warning(
                            "curriculum.promote_strict is set but "
                            f"{cur_nonstrict_done} episodes completed with zero strict-spawn "
                            "counters: the task does not report spawn_difficulty "
                            "(success_strict/done_strict); falling back to non-strict "
                            "promotion counting")
                        cur_strict = False
                        cur_succ = int(ep_count[0])
                        cur_done = int(ep_count.sum())
                else:
                    cur_succ += int(ep_count[0])
                    cur_done += int(ep_count.sum())
                if cur_done >= cur_min_episodes:
                    rate = cur_succ / cur_done
                    if rate >= cur_thresh:
                        difficulty = min(1.0, difficulty + cur_inc)
                        env_state = with_difficulty(env_state, difficulty)
                        logger.info(f"Curriculum: success rate {rate:.2f} over {cur_done} "
                                    f"episodes -> difficulty {difficulty:.2f}")
                        cur_cooldown_until = it + cur_cooldown_iters
                    cur_succ = cur_done = 0
            stats["difficulty"] = difficulty

            if m["reward_mean"] > best_reward and it >= int(
                    get_by_path(cfg, "train.params.config.save_best_after", 1)):
                best_reward = m["reward_mean"]
                if main_rank:
                    save_checkpoint(os.path.join(nn_dir, f"{task_name}_best.pt"), ppo,
                                    {"iteration": it, "reward": best_reward,
                                     "difficulty": difficulty}, learner)
        if main_rank and (crossed(save_freq) or it == max_iters):
            path = os.path.join(nn_dir, f"{task_name}_ep{it}.pt")
            meta = {"iteration": it, "difficulty": difficulty}
            save_checkpoint(path, ppo, meta, learner)
            save_checkpoint(os.path.join(nn_dir, "latest.pt"), ppo, meta, learner)
            logger.info(f"Saved checkpoint: {path}")
    profiler.stop()
    if writer:
        writer.close()
    logger.info("Training complete")
    return 0


def masked_reset(env, state: EnvState, env_idx: int, samples=None) -> EnvState:
    """The viewer's E key: a fresh `reset_fn` state merged into env
    `env_idx`'s rows of every leaf whose leading dimension is the env count;
    the other envs' rows and the other leaves stay. `samples` as in
    `reset_fn`; drawn from the env's generator when omitted."""
    fresh, _ = env.reset_fn(samples)
    mask = torch.arange(env.num_envs, device=env.device) == env_idx

    def merge(new, cur):
        if isinstance(new, torch.Tensor):
            if new.ndim >= 1 and new.shape[0] == env.num_envs:
                return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, cur)
            return cur
        if isinstance(new, dict):
            return {k: merge(v, cur[k]) for k, v in new.items()}
        if dataclasses.is_dataclass(new):
            return dataclasses.replace(cur, **{f.name: merge(getattr(new, f.name),
                                                             getattr(cur, f.name))
                                               for f in dataclasses.fields(new)})
        return cur

    return merge(fresh, state)


class Sidecar:
    """Evaluation's graphics (graphics/): the renderer and, as configured,
    the mp4 recorder, the MJPEG streamer and the interactive viewer with
    its E-key reset request and random-action flag. Frames are drawn on
    the host from the state each step returns."""

    def __init__(self, cfg, env, run_dir: str, logger):
        self.env, self.logger = env, logger
        self.recorder = self.streamer = self.viewer = None
        self.random_actions, self.reset_request, self.resets, self.frames = False, None, [], 0
        params = env.comps.engine.params
        self.has_box, self.box2_size = params.has_box, params.box2_size
        resolution = get_by_path(cfg, "env.video.resolution", [640, 480])
        self.renderer = SceneRenderer(env.comps.model, resolution=tuple(resolution),
                                      box_size=params.box_size)
        if get_by_path(cfg, "env.videoRecord", False):
            out_dir = get_by_path(cfg, "env.video.outputDir") or os.path.join(run_dir, "videos")
            self.recorder = VideoRecorder(out_dir, max_duration_seconds=float(
                get_by_path(cfg, "env.video.maxDurationSeconds", 60)))
            self.recorder.finalize_fps(env.control_dt)
            self.recorder.start_episode()
        if get_by_path(cfg, "env.videoStream", False):
            self.streamer = HTTPVideoStreamer(
                host=get_by_path(cfg, "env.stream.host", "127.0.0.1"),
                port=int(get_by_path(cfg, "env.stream.port", 8080)))
            self.streamer.start()
        if get_by_path(cfg, "env.viewer", False):
            self.viewer = ViewerController(
                self.renderer, env.num_envs,
                on_reset_env=lambda i: setattr(self, "reset_request", i),
                on_toggle_random_actions=self._toggle_random, streamer=self.streamer,
                box2_size=self.box2_size)

    def _toggle_random(self) -> None:
        self.random_actions = not self.random_actions
        self.logger.info(f"Random actions: {self.random_actions}")

    def before_step(self, state: EnvState) -> EnvState:
        """The E key's masked reset of the selected env, on the device."""
        if self.reset_request is None:
            return state
        state = masked_reset(self.env, state, self.reset_request)
        self.logger.info(f"Viewer: reset env {self.reset_request}")
        self.resets.append(self.reset_request)
        self.reset_request = None
        return state

    def after_step(self, state: EnvState, games: int) -> None:
        """Draw the step's frame (the viewer's selected env, else env 0) and
        hand it to the recorder and the stream."""
        env, ph, force = self.env, state.physics, state.body_contact_force
        if self.viewer is not None:
            frame = self.viewer.render_env(env.comps.engine, ph, env._spawn, force, self.has_box)
        else:
            frame = env_rows(env.comps.engine, ph, env._spawn, force, 0).render(
                self.renderer, f"games {games}", has_box=self.has_box, box2_size=self.box2_size)
            if self.streamer is not None:
                self.streamer.add_frame(frame)
        if self.recorder is not None:
            self.recorder.add_frame(frame)
        self.frames += 1

    def summary(self) -> Dict[str, Any]:
        out = {"frames": self.frames, "resets": list(self.resets),
               "random_actions": self.random_actions}
        if self.viewer is not None:
            out.update(selected_env=self.viewer.selected_env,
                       view_mode=self.viewer.view_mode_idx)
        if self.streamer is not None:
            out["stream"] = self.streamer.stats()
        return out

    def close(self) -> None:
        if self.viewer is not None:
            self.viewer.close()
        if self.recorder is not None:
            self.recorder.stop_episode()
            self.recorder.close()
        if self.streamer is not None:
            self.streamer.stop()


def run_test(s: CliRun) -> int:
    """Deterministic evaluation for testGamesNum episodes (0 = until
    interrupted) at difficulty 1.0, with checkpoint hot-reload and, where
    configured, the graphics sidecar. Logs the termination reasons' rates
    per episode; `s.stats` gets the counts."""
    cfg, env, learner, logger = s.cfg, s.env, s.learner, s.logger
    games_target = int(get_by_path(cfg, "train.testGamesNum", 100))
    reload_interval = float(get_by_path(cfg, "train.reloadInterval", 30))
    ppo_box = {"state": s.ppo}
    monitor = None
    spec = get_by_path(cfg, "train.checkpoint")
    if spec:
        path = resolve_checkpoint(str(spec), base_dir=os.environ.get("DEXHAND_RUNS_DIR", "."))

        def on_reload(p):
            ppo_box["state"] = load_checkpoint(p, ppo_box["state"])
            logger.info(f"Reloaded weights from {p}")

        monitor = HotReloadMonitor(path, on_reload, reload_interval)
        monitor.start()
    sidecar = (Sidecar(cfg, env, s.run_dir, logger) if any(
        get_by_path(cfg, k, False) for k in ("env.videoRecord", "env.videoStream", "env.viewer"))
        else None)
    # evaluation runs the full reset distribution, whatever the curriculum's
    # initial difficulty
    if env.comps.initial_difficulty != 1.0:
        env.comps.initial_difficulty = 1.0
        logger.info("Eval: curriculum difficulty forced to 1.0 (full reset distribution)")
    env_state, obs = env.reset_fn()
    games, returns = 0, []
    ep_ret = np.zeros(env.num_envs)
    succ = fail = tout = 0
    # each terminal attributed to the criteria that fired in its episode
    reason_counts: Dict[str, int] = {}
    try:
        while games_target == 0 or games < games_target:
            t_frame = time.time()
            if sidecar is not None:
                env_state = sidecar.before_step(env_state)
            if sidecar is not None and sidecar.random_actions:
                actions = torch.rand(env.num_envs, env.num_actions, generator=env.generator,
                                     device=env.device) * 2 - 1
            else:
                actions = learner.act_deterministic(ppo_box["state"], obs)
            env_state, obs, rew, done, extras = env.step_fn(env_state, actions)
            if sidecar is not None:
                sidecar.after_step(env_state, games)
                if sidecar.viewer is not None:
                    # real-time pacing to control_dt
                    lag = env.control_dt - (time.time() - t_frame)
                    if lag > 0:
                        time.sleep(lag)
            ep_ret += rew.cpu().numpy()
            done_h = done.cpu().numpy()
            if done_h.any():
                idx = np.nonzero(done_h)[0]
                returns.extend(ep_ret[idx].tolist())
                ep_ret[idx] = 0.0
                games += len(idx)
                succ += int(extras["success"].cpu().numpy()[idx].sum())
                fail += int(extras["failure"].cpu().numpy()[idx].sum())
                tout += int(extras["timeout"].cpu().numpy()[idx].sum())
                for k, v in extras.items():
                    if k.startswith(("success_reason_", "failure_reason_")):
                        reason_counts[k] = reason_counts.get(k, 0) + int(
                            v.cpu().numpy()[idx].sum())
                logger.info(f"games {games}/{games_target or 'inf'} avg return "
                            f"{np.mean(returns):.2f} success {succ} failure {fail} "
                            f"timeout {tout}")
    except KeyboardInterrupt:
        logger.info("Interrupted")
    finally:
        if monitor:
            monitor.stop()
        summary = None
        if sidecar is not None:
            summary = sidecar.summary()
            sidecar.close()
    if returns:
        logger.info(f"Evaluation: {len(returns)} episodes, avg return {np.mean(returns):.3f}, "
                    f"success rate {succ / max(1, len(returns)):.3f}")
        if reason_counts:
            n_ep = max(1, len(returns))
            split = ", ".join(f"{k.replace('_reason_', ':')} {v / n_ep:.3f}"
                              for k, v in sorted(reason_counts.items()) if v)
            logger.info(f"Termination reasons: {split or 'none fired'}")
    s.stats.append({"episodes": len(returns), "success": succ, "failure": fail,
                    "timeout": tout, "reasons": reason_counts,
                    **({"sidecar": summary} if summary is not None else {})})
    return 0


if __name__ == "__main__":
    sys.exit(main())

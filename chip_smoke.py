"""On-card smoke run of the torch port (`dexrobot_isaac_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero, printing no
result, without them or outside a checkout of this repository. Phases, each
failing the run when it fails:

1. build   compile every kernel build of csrc/ (kernel_build.BUILDS: K1 for
           each of the six tasks, K2 for one box and for two, K3, the
           learner's clip + Adam) with nvcc
           for sm_90a (one nvcc per build, started together); print the
           build seconds and the ptxas register/spill report, each kernel's
           shared bytes per block and resident blocks (envs, or K3's
           systems) per SM (every K1 and K2 build, the two-box builds
           included, must hold 32 envs per SM), and the card's name and
           power limit.
2. golden  replay tests/golden/fused_blind_grasping.npz (recorded from the
           TPU kernel) through the CUDA fused kernel K1 with the JAX-sampled
           operands of dexrobot_isaac_tpu_torch/data/golden_operands.npz;
           obs atol 2e-4, reward and components atol 1e-3, done exact.
3. K2      at 4096 envs of the default BlindGrasping config, from a
           contact-rich state (plain steps of random actions): one control
           step of the lane-physics kernel against the plain engine, and
           min_site_z against the plain FK.
4. K1      one fused step at 4096 envs against the plain fused step, and a
           second launch on the same inputs, bitwise equal to the first.
   box2    K2's two-box build against the plain engine at 4096 envs of
           BoxStacking, a quarter of them with the pick cube resting on the
           platform and a quarter with it dropped onto it (cube-cube,
           platform-ground and hand contacts active; the envs with cube-cube
           contact are counted and must be more than 0): q, qd, both boxes'
           rows and the 6 box-force rows within 1e-3 relative; two launches
           bitwise equal.
   stacking K1's BoxStacking build against the plain fused step at 4096 envs
           of that state, half of them resetting: no mask mismatch, obs
           atol 2e-4, reward and components atol 1e-3; two launches bitwise
           equal.
   base    K1's BaseTask build (position_delta actions, no task step) the
           same way.
   tasks   K1's BoxReorientation, InHandReorientation (the box pinched in
           mid-air) and BoxPushing builds the same way, each at 4096 envs
           after 3 plain steps of random actions. The pinch is
           ill-conditioned over a control step's 16 substeps: the plain
           version run on the host's CPU instead of the card already leaves
           those tolerances in a few envs, and that count is printed. So
           InHandReorientation's build is held to them in every env at one
           substep per launch, and at 16 in all but at most 1% of the envs.
   recipe  K1's BlindGrasping build the same way on the README recipe
           (experiments=BlindGraspingCurriculum: 40 observation keys with
           the asymmetric critic) at 8192 envs, its numEnvs, and on
           BlindGraspingClearance (443 output words per env) at 4096.
5. K3      the SPD solve kernel on the 4096 systems (A, rhs) of one Coriolis
           substep from phase 3's contact-rich state, and on their first
           4095 and first 1, against its plain version (relative 1e-5); both
           also against a float64 solve; a second launch on the same inputs
           bitwise equal to the first.
6. coriolis one Coriolis control step at 4096 envs through make_control_step
           (the engine's ops with K3) against the plain Coriolis sequence:
           q, qd, box, contact force within 1e-3 relative.
   clip_adam the learner's clip + Adam kernel pair (csrc/clip_adam.cu)
           against its plain version over one README-recipe iteration's 64
           minibatch updates of the recipe's network (17 leaves), the clip
           engaged in every other one: params within 1e-6 absolute after
           the 64, the step count, 2 launches per update, a second run
           bitwise equal; whether one update with gradients whose norm sums
           exactly in any order is bitwise equal to the plain version's is
           printed; one update under torch.profiler runs the two launches
           and no other device op; ms per launch pair queued and paced, the
           plain version's ms and the byte bound. `python3 chip_smoke.py
           --clip-adam` runs this phase alone.
7. main    the port's main path, counted: make_env -> reset -> 600 fused
           steps of uniform random actions in [-1, 1] (episodeLength 500, so
           auto-resets fire), then 10 unfused (evaluation-path) steps.
           Launch counters are zeroed just before and read just after. The
           same for BoxStacking (600 fused steps through K1's BoxStacking
           build, 10 unfused through K2's two-box build), for BaseTask (100
           fused steps) and for BoxReorientation, InHandReorientation and
           BoxPushing (320 fused steps each, past their 300-step episodes,
           and 10 unfused), each path counted on its own.
8. train   the CLI trainer (dexrobot_isaac_tpu_torch/train.py run_train)
           in-process on BlindGrasping at 4096 envs, default config (horizon
           16): 3 iterations on the fused step (K1 launches = 3 x 16, the
           clip + Adam kernel's 2 per minibatch update), then 1
           with sim.coriolis=true fused=off (K3 launches = 16 x 16), then
           evaluation (test=true) from the checkpoint just written (K2
           launches > 0); counters zeroed before and read after each run.
           Metrics (KL, mean reward) and params finite; training env-steps/s
           with each iteration's rollout and update time. Then BoxStacking:
           2 iterations (one dispatch chunk of 2) with fused=auto, which
           must take K1's BoxStacking build, and an evaluation from its
           checkpoint (the unfused step: K2's two-box build). Then 1
           iteration each of BoxReorientation, InHandReorientation and
           BoxPushing with fused=auto, which must take the task's K1 build,
           and an evaluation from the InHandReorientation checkpoint (K2).
   rules   the env's user surface (`surface_phases`): the harness's
           rule-based BlindGrasping task (tools/dexhand_test.py: a circle of
           the base and an adaptive grasp as the pre-action rule, 0 policy
           actions) at 4096 envs: make_fused declines it naming the rule;
           one unfused step through K2 against the plain step on the same
           inputs (obs atol 2e-4, reward atol 1e-3, done exact); then 100
           steps, counted: K2 launches 100 and the base of env 0 moves more
           than 1 mm.
   mjcf    BlindGrasping on env.handAsset (the vendored MJCF hand, whose
           spheres and finger pairs come in another order) at 4096 envs:
           K1 against the plain fused step (no mask mismatch, obs atol
           2e-4, reward atol 1e-3), K2 against the plain engine (1e-3
           relative), the built-in hand's K1 on the same inputs (printed),
           and one training iteration through the CLI with fused=auto,
           which must take K1.
   export  the [train] checkpoint exported as npz, bin and TorchScript; on
           4096 rollout observations the TorchScript module on the card and
           NumpyPolicy on the host agree with act_deterministic within 1e-4.
   profile the CLI with train.profile=1 for 2 BaseTask iterations: the
           trace exists and names K1's kernel (fused_step_kernel).
   diag    tools/diag_rollout.py from the [train] checkpoint, 4096 envs x 50
           steps on the unfused step: K2 launches 50.
   graphics the evaluation path's graphics sidecar (`graphics_phase`;
           OpenCV imports on the card's machine, matplotlib does not, so
           the mp4 and the MJPEG stream run here and the viewer's window
           is not drawn): env 0's 640x480 frame from K2's state after 3
           random steps at 4096 envs against the plain step's (at most
           0.5% of the pixels differ) and against the FK of every env
           (bitwise); the E key's masked reset and one K2 step against the
           same step without it (every other env's rows bitwise equal);
           the CLI's evaluation from the [train] checkpoint with the
           viewer, the stream and the mp4 (episodeLength 40), the keys
           Enter, ArrowUp, e and space sent through the stream's /control
           after frame 5: view mode 1, selected env 1, random actions on,
           one reset of env 1, K2 launches = frames = the stream's
           frames_received, an mp4 over 1 kB, the termination reasons
           printed; evaluation env-steps/s with the sidecar off and on
           (mp4 + MJPEG, unpaced; the same steps); ms per frame split into
           FK + copy to the host, rasterizing, JPEG and mp4v encoding;
           BoxStacking, 10 unfused steps through K2's two-box build, env
           0's frame holding pixels of the second box's colour.
   tools   the measurement tools (`tools_phase`): the bench entry as a user
           runs it (`python -m dexrobot_isaac_tpu_torch.bench 4096 48`, a
           subprocess): its JSON line parses, value and median are
           positive, f32_mfu and mfu in (0, 1], both paths timed and K1's
           and K2's launches a warm-up chunk plus 5 windows; then in this
           process the update anatomy at 4096 envs (JAX's ten configs and
           the split of the baseline iteration, whose parts sum to within
           10% of it), the train anatomy at 4096 envs with chunks 8 (K1's
           launches counted), bench_kernel at 4096 and 8192 envs (K2),
           K1's roofline at the bench's rate, measure_coriolis over a 0.1 s
           sweep (each substep's solve through K3), and record_golden into
           a temporary npz: the TPU golden's keys, shapes and dtypes,
           replayed against it at the golden budgets. Their launches join
           the kernels line (`launches_tools`).
   dist   multi-process training (`dist_phase`): the CLI in subprocesses
           (`python3 chip_smoke.py --dist-worker ...`, each cut at
           DIST_TIMEOUT s) with torchrun's environment. (a) NCCL at world
           size 1: BlindGrasping, 4096 envs, 2 PPO iterations on K1, and the
           same command without the environment; the two runs' latest.pt
           (params and optimizer state) within 1e-6 (0.0 expected). (b) two
           ranks sharing the card over gloo (NCCL refuses two ranks on one
           card), 2048 envs each, 2 iterations with a curriculum that
           promotes after the first: params bitwise equal across the ranks
           after each iteration, difficulty and consecutive successes equal,
           the ranks' first reset draws different, K1 launches 32 per rank,
           only rank 0 writes the checkpoint, and one minibatch update with
           fixed data split in half across the ranks matches the
           single-process update of the whole minibatch (KL 1e-5 relative,
           live params atol 1e-6); global env-steps/s printed.
9. numbers env-steps/s of the 600-step rollout and each kernel's ms per
           launch, device time with its launches queued behind a sleeping
           kernel so that the host's launch overhead stays out
           (kernel_build.device_ms; every build on its phase's inputs; K1's
           BlindGrasping and BoxStacking builds also at 8192 envs, the
           README recipe's width, their phase inputs twice; K3 warm, the
           phase-5 systems back to back in L2, and cold, rotating over 12 copies of them, twice the L2), and
           again with the host pacing the launches (CUDA events around the
           calls, as the plain versions and library calls are timed),
           beside its plain version's ms, its bound on the card (bytes or
           f32 operations counted for these inputs) and, where one PyTorch
           call computes the same function, that call's ms; the device's
           busy share over 20 fused steps under torch.profiler.

The line before the last is a JSON object of the kernels; the last line is
the run's result: {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
kb = None  # dexrobot_isaac_tpu_torch.utils.kernel_build, imported by main()
GOLDEN = os.path.join(ROOT, "tests", "golden", "fused_blind_grasping.npz")
N_ENVS = 4096
ROLLOUT_STEPS = 600
# the single-box tasks' K1 builds; their paths run 320 fused steps (past
# their 300-step episodes, so auto-resets fall in the window)
NEW_TASKS = {"BoxReorientation": "fused_step_reorient", "InHandReorientation": "fused_step_inhand",
             "BoxPushing": "fused_step_pushing"}
TASK_STEPS = 320
# one 2.5 ms substep per control step (a control step is 16 of them)
ONE_SUBSTEP = ["sim.dt=0.0025", "sim.substeps=1", "sim.physics_steps_per_control=1"]
# the golden scenario (tests/golden_scenario.py)
GOLDEN_CONFIG = ["task=BlindGrasping", "numEnvs=8", "env.episodeLength=6", "sim.substeps=2"]
GOLDEN_SEED = 123


DIST_TIMEOUT = 300  # seconds for each [dist] subprocess
DIST_ITERS = 2


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def occupancy(kb, lane_step) -> dict:
    """{kernel build: (shared bytes per block, resident blocks per SM, envs
    or systems per block)} from the libraries' occupancy exports."""
    import ctypes

    out = {}
    envs = lane_step.shared_layout(kb.load("control_step"))[2]
    for name in kb.BUILDS:
        lib, v = kb.load(name), [ctypes.c_int() for _ in range(4)]
        if kb.BUILDS[name][0] == "control_step":
            check(lib.control_step_occupancy(*map(ctypes.byref, v)) == 0,
                  f"{name} occupancy query failed")
            out[name] = (v[0].value, v[1].value, envs)
            if name == "control_step":
                out["min_site_z"] = (v[2].value, v[3].value, envs)
        elif kb.BUILDS[name][0] == "fused_step":
            check(lib.fused_step_occupancy(*map(ctypes.byref, v[:2])) == 0,
                  f"{name} occupancy query failed")
            out[name] = (v[0].value, v[1].value, envs)
        elif name == "spd_solve":
            check(lib.spd_solve_occupancy(*map(ctypes.byref, v[:3])) == 0,
                  f"{name} occupancy query failed")
            out[name] = (v[0].value, v[1].value, v[2].value)
    return out


def device_ms_twice(kernel, fs, ins) -> float:
    """K1's device ms per launch (`kb.device_ms`) on twice the envs: the fused
    state's columns and the operands `ins` side by side, the state rows
    restored before each launch (K1 writes them in place)."""
    w2 = lambda x: torch.cat([x, x], 1).contiguous()
    rf0, ri0 = w2(fs.rows_f), w2(fs.rows_i)
    rf, ri, ins2 = rf0.clone(), ri0.clone(), [w2(x) for x in ins]

    def run():
        rf.copy_(rf0)
        ri.copy_(ri0)
        return kernel(rf, ri, *ins2)

    return kb.device_ms(run, 10)


def envs_off(out_a, rf_a, ri_a, out_b, rf_b, ri_b):
    """Per env: whether two K1 results (kernel or plain) disagree beyond the
    tolerances: a mask, obs atol 2e-4, reward or a component atol 1e-3,
    rows_f beyond 1e-3 of its largest value, or rows_i."""
    scale = rf_b.abs().max().clamp_min(1e-6)
    return ((out_a[3] != out_b[3]).any(0) | ((out_a[1] - out_b[1]).abs().amax(0) > 2e-4)
            | ((out_a[2] - out_b[2]).abs().amax(0) > 1e-3)
            | ((out_a[4] - out_b[4]).abs().amax(0) > 1e-3)
            | ((rf_a - rf_b).abs().amax(0) > 1e-3 * scale) | (ri_a != ri_b).any(0))


def k1_vs_plain(fused, env, state, gen, dev, n):
    """K1 (`fused.kernel`) against its plain version on `state` packed, every
    other env at its last step (the reset merge runs on half), and a second
    K1 launch on the same inputs. Returns (errors, the K1 inputs, K1's
    outputs, the number of dones, the plain version's outputs and rows)."""
    fs = fused.pack(state)
    fs.rows_i[fused.layout.offs_i["episode_step_count"][0], ::2] = (
        env.comps.term_cfg.max_episode_length - 2)
    acts = torch.rand(n, env.num_actions, generator=gen, device=dev) * 2 - 1
    reset, drs = env.draw_samples(n, fs.difficulty)
    rst, drn = fused.operand_rows(reset, drs, n, dev)
    spw = env._spawn[:, None].expand(3, n).contiguous()
    ins = (acts.t().contiguous(), rst, drn, spw)
    rf_k, ri_k, rf_p, ri_p, rf_k2, ri_k2 = (x.clone() for x in (fs.rows_f, fs.rows_i) * 3)
    ko = fused.kernel(rf_k, ri_k, *ins)
    po = fused.kernel_plain(rf_p, ri_p, *ins)
    ko2 = fused.kernel(rf_k2, ri_k2, *ins)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((rf_k, ri_k, *ko), (rf_k2, ri_k2, *ko2)))
    mism = (ko[3] != po[3]).any(0)
    ok = ~mism
    err = {"mask_mismatches": int(mism.sum()), "bitwise": same,
           "obs": float((ko[1][:, ok] - po[1][:, ok]).abs().max()),
           "rew": float((ko[2][:, ok] - po[2][:, ok]).abs().max()),
           "comp": float((ko[4][:, ok] - po[4][:, ok]).abs().max()),
           "rows_f": rel_err(rf_k[:, ok], rf_p[:, ok]),
           "rows_i_equal": bool(torch.equal(ri_k[:, ok], ri_p[:, ok])),
           "envs_off": int(envs_off(ko, rf_k, ri_k, po, rf_p, ri_p).sum())}
    return err, (fs, ins), ko, int(ko[3][0].sum()), (po, rf_p, ri_p)


def plain_spread(config, fs, ins, plain):
    """The plain version against itself: the same inputs through the plain
    fused step on the host's CPU (the same code in other orders of
    summation) against its run on the card. Returns the envs where the two
    disagree beyond K1's tolerances (`envs_off`)."""
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    n = fs.rows_f.shape[1]
    env_c = make_env(load_config(config + [f"numEnvs={n}"]), seed=9, device="cpu")
    rf_c, ri_c = fs.rows_f.cpu().clone(), fs.rows_i.cpu().clone()
    pc = env_c.make_fused().kernel_plain(rf_c, ri_c, *(x.cpu() for x in ins))
    dev = fs.rows_f.device
    po, rf_p, ri_p = plain
    return envs_off(tuple(x.to(dev) for x in pc), rf_c.to(dev), ri_c.to(dev), po, rf_p, ri_p)


def rollout(env, fused, gen, dev, n, steps, unfused_steps):
    """The counted main path of a task: reset, `steps` fused steps of
    uniform random actions, then `unfused_steps` of the unfused step (the
    evaluation path); launch counters zeroed before and read after. Returns
    (env-steps/s of the fused steps, dones, finite, obs shape, launches)."""
    torch.cuda.synchronize()
    kb.reset_launches()
    fs, obs = fused.reset()
    n_dones, finite = 0, True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        acts = torch.rand(n, env.num_actions, generator=gen, device=dev) * 2 - 1
        fs, obs, rew, done, _ = fused.step_fn(fs, acts)
        n_dones += done.sum()
        if step % 100 == 99:
            finite &= bool(torch.isfinite(obs).all() & torch.isfinite(rew).all())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    finite &= bool(torch.isfinite(obs).all() & torch.isfinite(rew).all())
    env.state = fused.unpack(fs)
    for _ in range(unfused_steps):
        obs_u, rew_u, _, _ = env.step(torch.rand(n, env.num_actions, generator=gen, device=dev) * 2 - 1)
        finite &= bool(torch.isfinite(obs_u).all() & torch.isfinite(rew_u).all())
    torch.cuda.synchronize()
    return steps * n / secs, int(n_dones), finite, tuple(obs.shape), dict(kb.LAUNCHES)


def _task_env(make_env, load_config, gen, dev, config, n=N_ENVS, k=3):
    """`config` (a task= or experiments= override and others) at n envs
    after k plain steps of random actions: (env, fused, state)."""
    env = make_env(load_config(config + [f"numEnvs={n}"]), seed=9, device=dev)
    return env, env.make_fused(), plain_steps(env, gen, dev, n, k)


def plain_steps(env, gen, dev, n, k):
    """`k` plain steps (the plain fused step's ops) of uniform random
    actions from a reset: a contact-rich state."""
    state, _ = env.reset_fn()
    for _ in range(k):
        samples = env.draw_samples(n, state.difficulty)
        acts = torch.rand(n, env.num_actions, generator=gen, device=dev) * 2 - 1
        state, *_ = env._step(state, acts, *samples, env._plain_control_step)
    return state


MJCF_XML = os.path.join(ROOT, "dexrobot_isaac_tpu", "assets",
                        "dexhand021_right_simplified_floating.xml")
RULE_STEPS = 100
DIAG_STEPS = 50


def unfused_vs_plain(env, state, acts):
    """One unfused step through K2 (`env._control_step`) and through the
    plain engine, on the same state, actions and samples: the max errors of
    obs (and the next rule targets) and reward, the done-mask mismatches
    and the dones."""
    samples = env.draw_samples(state.physics.q.shape[0], state.difficulty)
    ks, ko, kr, kd, _ = env._step(state, acts, *samples, env._control_step)
    ps, po, pr, pd, _ = env._step(state, acts, *samples, env._plain_control_step)
    torch.cuda.synchronize()
    rule = float((ks.active_rule_targets - ps.active_rule_targets).abs().max())
    return (max(float((ko - po).abs().max()), rule), float((kr - pr).abs().max()),
            int((kd != pd).sum()), int(pd.sum()))


def dist_worker(out: str, backend: str, argv) -> int:
    """A rank of [dist] (`chip_smoke.py --dist-worker <out> <backend|-> <CLI
    args>`, torchrun's environment set by `dist_phase`): the CLI's training
    in this process, counted, with the first reset draws, the params and
    (consecutive successes, difficulty) after each iteration; at world size
    2 also the split minibatch update. Writes its report to `out`."""
    sys.path.insert(0, ROOT)
    from dexrobot_isaac_tpu_torch import train as cli
    from dexrobot_isaac_tpu_torch.parallel.mesh import init_distributed
    from dexrobot_isaac_tpu_torch.utils import kernel_build
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    cfg = load_config(argv)
    if backend != "-":
        init_distributed(cli.cli_device(cfg), backend=backend)
    s = cli.build(cfg)
    try:
        env, learner, dev = s.env, s.learner, s.learner.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        rep = {"draws": [], "params": [], "state": [], "rank": s.group.rank,
               "backend": s.group.backend, "num_envs": env.num_envs,
               "horizon": learner.cfg.horizon_length}
        draw, iterate = env.draw_samples, learner.train_iteration

        def recording_draw(n, difficulty):
            samples = draw(n, difficulty)
            if not rep["draws"]:
                rep["draws"].append(samples[0].dof_pos.cpu())
            return samples

        def recording_iteration(ppo, env_state, obs):
            res = iterate(ppo, env_state, obs)
            rep["params"].append({k: v.cpu() for k, v in res[0].params.items()})
            rep["state"].append((int(res[1].consecutive_successes), float(res[1].difficulty)))
            return res

        env.draw_samples, learner.train_iteration = recording_draw, recording_iteration
        sync()
        kernel_build.reset_launches()
        rep["rc"] = cli.run_train(s)
        sync()
        rep["launches"] = dict(kernel_build.LAUNCHES)
        rep["stats"], rep["run_dir"] = s.stats, s.run_dir
        if s.group.world_size == 2:
            rep["split"] = split_update(s)
        torch.save(rep, out)
    finally:
        s.group.close()
    return 0


def split_update(s) -> dict:
    """One minibatch update of the trained learner with fixed data (drawn
    alike on every rank), each rank holding its half, against the update of
    a learner without a group on the whole minibatch (on each rank): the KL's
    relative error, the max abs error of the params where the gradient is
    above 1e-6 ("live"), and over all params."""
    from dexrobot_isaac_tpu_torch.rl.ppo import PPOLearner, _gaussian_log_prob

    learner, ppo, group = s.learner, s.ppo, s.group
    cfg, dev = learner.cfg, learner.device
    m = cfg.minibatch
    gen = torch.Generator(device=dev).manual_seed(5)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    obs = ppo.obs_rms.mean + torch.sqrt(ppo.obs_rms.var) * rn(m, cfg.obs_width)
    mu, log_std, value = learner._forward(ppo.params, ppo.obs_rms, obs)
    action = mu + torch.exp(log_std) * rn(*mu.shape)
    mb = [obs, action, _gaussian_log_prob(mu, log_std, action) + 0.3 * rn(m),
          value + 0.3 * rn(m), rn(m), rn(m), mu + 0.1 * rn(*mu.shape),
          torch.exp(log_std + 0.1 * rn(*mu.shape))]
    carry = (ppo.params, ppo.opt_state, ppo.lr, ppo.obs_rms, ppo.value_rms,
             torch.zeros((), device=dev))
    rows = group.shard_slice(m)
    (split, _, _, _, _, _), kl = learner._update_minibatch(carry, [x[rows] for x in mb])
    alone = PPOLearner(cfg, None, seed=0, device=dev)
    grads, _, _ = alone._grads(ppo.params, ppo.obs_rms, mb)
    (whole, _, _, _, _, _), kl_whole = alone._update_minibatch(carry, mb)
    live = {k: g.abs() > 1e-6 for k, g in grads.items()}
    return {"minibatch": m, "kl": float(kl), "kl_whole": float(kl_whole),
            "kl_rel": abs(float(kl) - float(kl_whole)) / abs(float(kl_whole)),
            "live_err": max(float((split[k] - whole[k])[live[k]].abs().max()) for k in split),
            "all_err": max(float((split[k] - whole[k]).abs().max()) for k in split)}


def clip_adam_phase(dev, card: str) -> dict:
    """[clip_adam] (see the docstring): the learner's clip + Adam kernel pair
    against its plain version over one README-recipe iteration's minibatch
    updates on the recipe's network; returns the kernels-line row's
    numbers."""
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.ops import clip_adam as ca
    from dexrobot_isaac_tpu_torch.rl.ppo import AdamState, PPOLearner, ppo_config_from
    from dexrobot_isaac_tpu_torch.tools.roofline import bound
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    recipe = ["experiments=BlindGraspingCurriculum"]
    env = make_env(load_config(recipe + ["numEnvs=8"]), seed=0, device=dev)
    cfg = dataclasses.replace(ppo_config_from(load_config(recipe), env), num_envs=8192)
    learner = PPOLearner(cfg, None, seed=0, device=dev)
    st = learner.init_state()
    updates = cfg.mini_epochs * max(1, cfg.batch_size // cfg.minibatch)
    total = sum(v.numel() for v in st.params.values())
    gen = torch.Generator(device=dev).manual_seed(15)
    # gradients of norm ~7 (the clip engages) and ~0.35 (it does not), in turn
    grads = [{k: (1e-2 if j % 2 == 0 else 5e-4)
              * torch.randn(v.shape, generator=gen, device=dev) for k, v in st.params.items()}
             for j in range(updates)]
    lr = st.lr

    def run_kernel():
        p, opt = st.params, st.opt_state
        for g in grads:
            p, opt = learner._apply_updates(p, opt, g, lr)
        return p, opt

    before = kb.LAUNCHES["clip_adam"]
    pk, ok = run_kernel()
    torch.cuda.synchronize()
    launches = kb.LAUNCHES["clip_adam"] - before
    pk2, ok2 = run_kernel()
    pp, op = st.params, st.opt_state
    for g in grads:
        new, count, mu, nu = ca.clip_adam_plain(pp, g, op.mu, op.nu, op.count, lr, cfg.grad_norm)
        pp, op = new, AdamState(count, mu, nu)
    torch.cuda.synchronize()
    gap = lambda a, b: max(float((a[k] - b[k]).abs().max()) for k in a)
    bits = lambda a, b: all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)
    err = {"params": gap(pk, pp), "mu": gap(ok.mu, op.mu), "nu": gap(ok.nu, op.nu)}
    same_count = int(ok.count) == int(op.count) == updates
    repeat = bits(pk, pk2) and bits(ok.mu, ok2.mu) and bits(ok.nu, ok2.nu)
    # sums of g*g that are exact in any order: both sides reach the same
    # norm, so one update is bitwise equal unless a library's rounding differs
    exact = {k: torch.randint(-4, 5, v.shape, generator=gen, device=dev).float() / 64
             for k, v in st.params.items()}
    one_k = learner._apply_updates(st.params, st.opt_state, exact, lr)
    one_p = ca.clip_adam_plain(st.params, exact, st.opt_state.mu, st.opt_state.nu,
                               st.opt_state.count, lr, cfg.grad_norm)
    exact_bits = bits(one_k[0], one_p[0]) and bits(one_k[1].mu, one_p[2])
    log(f"[clip_adam] {updates} updates of the recipe's network ({len(st.params)} leaves, "
        f"{total:,} params): kernel vs plain max abs gap params {err['params']:.3e} (tol "
        f"1e-6), mu {err['mu']:.3e}, nu {err['nu']:.3e}; counts {int(ok.count)}, "
        f"{int(op.count)}; launches {launches} (2 per update); two runs bitwise equal {repeat}; "
        f"one update with an order-free norm bitwise equal to plain {exact_bits}")
    check(err["params"] <= 1e-6 and same_count and launches == 2 * updates and repeat,
          "the clip + Adam kernel disagrees with its plain version, or missed a launch")

    # one update under the profiler: the two launches and no other device op
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        learner._apply_updates(pk, ok, grads[0], lr)
        torch.cuda.synchronize()
    ops = [ev.name() for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == torch.autograd.DeviceType.CUDA
           and "annotation" not in str(getattr(ev, "activity_type", lambda: "")())]
    log(f"[clip_adam] device ops of one update: {ops}")
    check(len(ops) == 2 and all("clip_adam" in n for n in ops),
          f"one update ran other device ops than the kernel pair: {ops}")

    call = lambda: learner._apply_updates(pk, ok, grads[0], lr)
    plain = lambda: ca.clip_adam_plain(pk, grads[0], ok.mu, ok.nu, ok.count, lr, cfg.grad_norm)
    saved = kb.LAUNCHES["clip_adam"]
    ms, paced = kb.device_ms(call, 200), cuda_ms(call, 50)
    plain_ms = cuda_ms(plain, 20)
    kb.LAUNCHES["clip_adam"] = saved
    nbytes = 4 * 7 * total  # params, grads and both moments read; params and moments written
    bms, by = bound(nbytes, 18 * total)  # f32 operations per element, the norm's included
    log(f"[clip_adam] {ms:.5f} ms per launch pair on the card (queued; paced by the host "
        f"{paced:.5f}), plain {plain_ms:.4f} ms; bound {bms:.5f} ms ({by}, {nbytes / 1e6:.2f} "
        f"MB) = {ms / bms:.1f}x ({card})")
    return {"launches": launches, "err": err["params"], "ms": ms, "paced": paced,
            "plain": plain_ms, "bound": (bms, by)}


def dist_phase(n: int, extra=()) -> dict:
    """[dist] (see the docstring): (a) and (b), each run's ranks started
    together as subprocesses. `extra`: more CLI args (a CPU rehearsal passes
    device=cpu and small shapes). Returns {run: K1 launches}."""
    import shutil
    import subprocess
    import tempfile

    from dexrobot_isaac_tpu_torch.parallel.mesh import free_port
    from dexrobot_isaac_tpu_torch.rl.checkpoint import read_payload

    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    base = ["task=BlindGrasping", f"numEnvs={n}", f"maxIterations={DIST_ITERS}",
            "train.logging.noLogFile=true", "train.params.config.log_interval=1",
            f"train.params.config.save_frequency={DIST_ITERS}"]

    def run(ranks):
        """{name: (world, rank, port or None, backend, args)} -> {name: report}."""
        procs = {}
        for name, (world, rank, port, backend, args) in ranks.items():
            env = dict(os.environ, DEXHAND_RUNS_DIR=os.path.join(work, name))
            for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
                env.pop(k, None)
            if port is not None:  # one card: every rank on cuda:0
                env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
            os.makedirs(env["DEXHAND_RUNS_DIR"])
            logf = open(os.path.join(work, name + ".log"), "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 os.path.join(work, name + ".pt"), backend, *args],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT), logf)
        deadline = time.perf_counter() + DIST_TIMEOUT
        failed = []
        for name, (proc, logf) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = f"timed out after {DIST_TIMEOUT} s"
            logf.close()
            if rc != 0:
                failed.append(name)
                with open(logf.name) as f:
                    log(f"[dist] {name} failed ({rc}); the end of its output:\n{f.read()[-3000:]}")
        for proc, _ in procs.values():
            proc.kill()
            proc.wait()
        check(not failed, f"[dist] runs failed: {failed}")
        return {name: torch.load(os.path.join(work, name + ".pt"), weights_only=False)
                for name in ranks}

    def latest(name):
        runs = os.path.join(work, name, "runs_all")
        run_ = sorted(os.listdir(runs))
        check(len(run_) == 1, f"[dist] {name} wrote {len(run_)} runs")
        return os.path.join(runs, run_[0], "nn", "latest.pt")

    # ---- (a) NCCL at world size 1 against the same command alone
    t0 = time.perf_counter()
    ra = run({"nccl": (1, 0, free_port(), "-", base + list(extra)),
              "alone": (1, 0, None, "-", base + list(extra))})
    pa, pb = (read_payload(latest(k)) for k in ("nccl", "alone"))
    leaves = lambda p: [*p["params"].values(), *p["opt_state"]["mu"].values(),
                        *p["opt_state"]["nu"].values()]
    diff = max(float((a - b).abs().max()) for a, b in zip(leaves(pa), leaves(pb)))
    same_count = bool(torch.equal(pa["opt_state"]["count"], pb["opt_state"]["count"]))
    log(f"[dist] (a) world size 1 over {ra['nccl']['backend']} vs no group, {n} envs x "
        f"{DIST_ITERS} iterations: latest.pt params and optimizer state max abs diff {diff!r} "
        f"(expected 0.0, limit 1e-6), Adam counts equal {same_count}; K1 launches "
        f"{ra['nccl']['launches']['fused_step']} and {ra['alone']['launches']['fused_step']}; "
        f"{time.perf_counter() - t0:.1f} s")
    backend = "gloo" if "device=cpu" in extra else "nccl"
    k1_each = DIST_ITERS * ra["alone"]["horizon"]
    check(diff <= 1e-6 and same_count and ra["nccl"]["backend"] == backend
          and ra["alone"]["backend"] is None
          and all(r["launches"]["fused_step"] == k1_each for r in ra.values()),
          "[dist] (a): the run at world size 1 differs from the run without a group, or "
          "missed K1")

    # ---- (b) two ranks sharing the card over gloo, with a curriculum that
    # promotes after the first iteration (every env times out in it)
    t0 = time.perf_counter()
    cur = ["task.curriculum.enabled=true", "task.curriculum.min_episodes=1",
           "task.curriculum.promote_success_rate=0.0", "env.episodeLength=16"]
    port = free_port()
    rb = run({f"rank{r}": (2, r, port, "gloo", base + cur + list(extra)) for r in range(2)})
    r0, r1 = rb["rank0"], rb["rank1"]
    equal = [all(torch.equal(a[k], b[k]) for k in a) for a, b in zip(r0["params"], r1["params"])]
    k1 = [r["launches"]["fused_step"] for r in (r0, r1)]
    sps = [st["env_steps_per_s"] for st in r0["stats"]]
    wrote0 = os.path.exists(latest("rank0"))
    # a non-main rank makes no run directory: its `run_dir` is only a name
    quiet1 = os.listdir(os.path.join(work, "rank1")) == [] and not os.path.exists(r1["run_dir"])
    sp = r0["split"]
    log(f"[dist] (b) 2 gloo ranks on one card x {r0['num_envs']} envs = {n} global, "
        f"{DIST_ITERS} iterations: params bitwise equal across the ranks after each iteration "
        f"{equal}; (consecutive successes, difficulty) {r0['state']} and {r1['state']}; first "
        f"reset draws differ {not torch.equal(r0['draws'][0], r1['draws'][0])}; K1 launches "
        f"{k1}; rank 0 wrote latest.pt {wrote0}, rank 1 wrote nothing {quiet1}; global "
        f"env-steps/s per iteration {[round(x) for x in sps]} (not gated); "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[dist] (b) one minibatch update of {sp['minibatch']} samples split in half across "
        f"the ranks vs one process on the whole: KL {sp['kl']:.6e} vs {sp['kl_whole']:.6e} "
        f"(relative {sp['kl_rel']:.2e}, tol 1e-5); live params max abs err "
        f"{sp['live_err']:.2e} (atol 1e-6), all params {sp['all_err']:.2e}")
    check(all(equal) and len(equal) == DIST_ITERS and r0["state"] == r1["state"]
          and r0["state"][-1][1] > 0.0 and not torch.equal(r0["draws"][0], r1["draws"][0])
          and wrote0 and quiet1 and r0["num_envs"] == r1["num_envs"] == n // 2
          and k1 == [k1_each] * 2, "[dist] (b): the two ranks diverged, drew alike, missed "
          "K1, or rank 1 wrote")
    check(sp["kl_rel"] <= 1e-5 and sp["live_err"] <= 1e-6,
          "[dist] (b): the split minibatch update misses the single-process update")
    shutil.rmtree(work)
    return {"a_nccl": ra["nccl"]["launches"]["fused_step"],
            "a_alone": ra["alone"]["launches"]["fused_step"], "b_rank0": k1[0], "b_rank1": k1[1]}


def surface_phases(dev, n, gen, train_run, tr, ckpt, horizon):
    """The env's user surface on the card: a rule-based controller
    ([rules]), the hand loaded from MJCF ([mjcf]), export of the [train]
    checkpoint ([export]), `train.profile` ([profile]) and `diag_rollout`
    ([diag]). Returns {phase: launches} of the counted runs."""
    from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.physics import lane_step
    from dexrobot_isaac_tpu_torch.physics.types import box_rows
    from dexrobot_isaac_tpu_torch.rl import export
    from dexrobot_isaac_tpu_torch.tools import dexhand_test, diag_rollout
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    counted = {}
    # ---- [rules]: the harness's rule-based controllers, 0 policy actions
    t0 = time.perf_counter()
    env = make_env(dexhand_test.rule_based_config(load_config(
        ["task=BlindGrasping", f"numEnvs={n}"])), seed=13, device=dev)
    check(env.num_actions == 0, f"the rule-based task has {env.num_actions} actions")
    try:
        env.make_fused()
        raise RuntimeError("make_fused accepted a task with a pre-action rule")
    except FusedUnsupported as e:
        log(f"[rules] make_fused declines: {e}")
        check("pre_action_rule" in str(e), "FusedUnsupported does not name the rule")
    state = plain_steps(env, gen, dev, n, 3)
    # every other env at its last step: the reset merge carries the rule's
    # targets of half the envs and the reset's of the others
    state.episode_step_count[::2] = env.comps.term_cfg.max_episode_length - 2
    acts = torch.zeros(n, 0, device=dev)
    e_obs, e_rew, mism, dones = unfused_vs_plain(env, state, acts)
    log(f"[rules] one unfused step (K2) vs the plain step at {n} envs from a contact-rich "
        f"state: done mismatches {mism} (dones {dones}), max abs err obs and rule targets "
        f"{e_obs:.3e} "
        f"(atol 2e-4) rew {e_rew:.3e} (atol 1e-3)")
    check(mism == 0 and dones >= n // 2 and e_obs <= 2e-4 and e_rew <= 1e-3,
          "the rule-based unfused step through K2 disagrees with the plain step")
    env.reset()
    xs = [float(env.state.physics.q[0, 0])]
    torch.cuda.synchronize()
    kb.reset_launches()
    t1 = time.perf_counter()
    for _ in range(RULE_STEPS):
        obs, rew, done, _ = env.step(acts)
        xs.append(float(env.state.physics.q[0, 0]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counted["rules"] = dict(kb.LAUNCHES)
    finite = bool(torch.isfinite(obs).all() & torch.isfinite(rew).all())
    log(f"[rules] {RULE_STEPS} rule-driven steps x {n} envs: {RULE_STEPS * n / secs:,.0f} "
        f"env-steps/s; base x of env 0 spans {max(xs) - min(xs):.4f} m; finite {finite}; "
        f"launches {counted['rules']}; phase {time.perf_counter() - t0:.1f} s")
    check(finite and max(xs) - min(xs) > 1e-3 and counted["rules"]["control_step"] == RULE_STEPS,
          "the rule-based path did not move the base or missed K2")

    # ---- [mjcf]: BlindGrasping on the hand loaded from the vendored MJCF file
    t0 = time.perf_counter()
    cfg_m = ["task=BlindGrasping", f"env.handAsset={MJCF_XML}"]
    env_m, fused_m, state_m = _task_env(make_env, load_config, gen, dev, cfg_m, n=n)
    builtin = make_env(load_config(["task=BlindGrasping", f"numEnvs={n}"]), seed=9, device=dev)
    check(not np.array_equal(env_m.comps.model.sphere_pos, builtin.comps.model.sphere_pos),
          "the MJCF hand's spheres come in the built-in order: the phase tests nothing new")
    err, (fs_m, ins_m), ko_m, done_m, _ = k1_vs_plain(fused_m, env_m, state_m, gen, dev, n)
    log(f"[mjcf] K1 {fused_m.build} vs plain at {n} envs on the MJCF hand: mask mismatches "
        f"{err['mask_mismatches']} (dones {done_m}); max abs err obs {err['obs']:.3e} (atol "
        f"2e-4) rew {err['rew']:.3e} (atol 1e-3) comp {err['comp']:.3e}; envs beyond the "
        f"tolerances {err['envs_off']}; two launches bitwise equal {err['bitwise']}")
    check(err["mask_mismatches"] == 0 and err["obs"] <= 2e-4 and err["rew"] <= 1e-3
          and err["bitwise"] and done_m >= n // 2, "K1 disagrees with the plain fused step on "
          "the MJCF hand")
    c_m = env_m.comps
    spawn = env_m._spawn.expand(n, 3)
    ph, tgt, dr = state_m.physics, state_m.full_dof_targets, state_m.dr
    kst, kinfo, kkin = lane_step.build_control_step(c_m.engine, c_m.physics_steps_per_control)(
        ph, tgt, spawn, dr)
    pst, pinfo, pkin = c_m.engine.plain_control_step(c_m.physics_steps_per_control)(
        ph, tgt, spawn, dr)
    torch.cuda.synchronize()
    k2m = {"q": rel_err(kst.q, pst.q), "qd": rel_err(kst.qd, pst.qd),
           "box": rel_err(box_rows(kst, False), box_rows(pst, False)),
           "contact_force": rel_err(kinfo.body_contact_force, pinfo.body_contact_force),
           "box_force": rel_err(kinfo.box_contact_force, pinfo.box_contact_force),
           "site_pos": rel_err(kkin.site_pos, pkin.site_pos)}
    n_contact = int((pinfo.body_contact_force.abs().sum((1, 2)) > 0).sum())
    log(f"[mjcf] K2 control step vs plain at {n} envs on the MJCF hand ({n_contact} envs in "
        "hand contact): relative err " + " ".join(f"{k} {v:.2e}" for k, v in k2m.items()))
    check(all(v <= 1e-3 for v in k2m.values()) and n_contact > 0,
          "K2 disagrees with the plain engine on the MJCF hand")
    rf_b, ri_b = fs_m.rows_f.clone(), fs_m.rows_i.clone()
    ko_b = builtin.make_fused().kernel(rf_b, ri_b, *ins_m)
    torch.cuda.synchronize()
    log(f"[mjcf] the built-in hand's K1 on the same inputs: max abs obs difference "
        f"{float((ko_b[1] - ko_m[1]).abs().max()):.3e} (printed, not gated: the two models "
        "order their spheres and pairs differently)")
    mj, mj_launches, mj_s = train_run(cfg_m + [
        f"numEnvs={n}", "train.logging.noLogFile=true", "maxIterations=1",
        "train.params.config.save_frequency=1", "train.params.config.log_interval=1"], True)
    counted["mjcf"] = mj_launches
    s_ = mj.stats[-1]
    log(f"[mjcf] 1 PPO iteration x {horizon} steps x {n} envs on the MJCF hand through the CLI "
        f"(fused=auto) in {mj_s:.2f} s, {s_['env_steps_per_s']:,.0f} env-steps/s; launches "
        f"{mj_launches}; phase {time.perf_counter() - t0:.1f} s")
    check(mj.fused is not None and mj.fused.build == "fused_step"
          and mj_launches["fused_step"] == horizon
          and np.isfinite(list(s_.values())).all(), f"MJCF training missed K1: {mj_launches}")

    # ---- [export]: the [train] checkpoint as npz, bin and TorchScript
    t0 = time.perf_counter()
    stem = os.path.splitext(ckpt)[0]
    paths = {fmt: export.EXPORTERS[fmt](ckpt, stem + ext) for fmt, ext in export.EXTENSIONS.items()}
    env_e = tr.env
    state_e, obs_e = env_e.reset_fn()
    for _ in range(5):  # rollout observations under the trained policy
        state_e, obs_e, *_ = env_e.step_fn(state_e, tr.learner.act_deterministic(tr.ppo, obs_e))
    ref = tr.learner.act_deterministic(tr.ppo, obs_e)
    ts = torch.jit.load(paths["torchscript"], map_location=dev)
    with torch.no_grad():
        a_ts = ts(obs_e)
    a_np = torch.as_tensor(export.NumpyPolicy.load(paths["npz"])(obs_e.cpu().numpy()), device=dev)
    torch.cuda.synchronize()
    w = export.extract_actor(ckpt)
    n_bin = 4 + 16 + 8 * int(w["num_obs"]) + sum(
        8 + 4 * (v.size + w[k[:-1] + "b"].size) for k, v in w.items() if k.endswith("_w"))
    d_ts, d_np = float((a_ts - ref).abs().max()), float((a_np - ref).abs().max())
    with open(paths["bin"], "rb") as f:
        head = f.read(4)
    log(f"[export] {os.path.relpath(ckpt, ROOT)} -> npz, bin ({os.path.getsize(paths['bin'])} "
        f"bytes), TorchScript; on {tuple(obs_e.shape)} rollout observations: TorchScript on the "
        f"card vs act_deterministic {d_ts:.3e}, NumpyPolicy on the host vs act_deterministic "
        f"{d_np:.3e} (tol 1e-4); {time.perf_counter() - t0:.1f} s")
    check(obs_e.shape[0] == n and d_ts <= 1e-4 and d_np <= 1e-4 and head == b"DXP1"
          and os.path.getsize(paths["bin"]) == n_bin, "an exported policy disagrees with "
          "act_deterministic, or the bin is malformed")

    # ---- [profile]: train.profile=1 on BaseTask, 2 iterations
    t0 = time.perf_counter()
    pr, pr_launches, pr_s = train_run([
        "task=BaseTask", f"numEnvs={n}", "train.logging.noLogFile=true", "maxIterations=2",
        "train.profile=1", "train.params.config.log_interval=1"], True)
    trace = os.path.join(pr.run_dir, "profile", "trace.json")
    with open(trace) as f:
        text = f.read()
    named = text.count("fused_step_kernel")
    log(f"[profile] 2 BaseTask iterations with train.profile=1 in {pr_s:.2f} s: "
        f"{os.path.relpath(trace, ROOT)} {len(text) / 1e6:.1f} MB, events naming "
        f"fused_step_kernel {named}; launches {pr_launches}; {time.perf_counter() - t0:.1f} s")
    check(named > 0 and pr_launches["fused_step_base"] == 2 * pr.learner.cfg.horizon_length,
          "the profile trace does not name K1's kernel")

    # ---- [diag]: diag_rollout from the [train] checkpoint
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kb.reset_launches()
    counts = diag_rollout.run(ckpt, "BlindGrasping", 1.0, n, DIAG_STEPS, dev.type)
    torch.cuda.synchronize()
    counted["diag"] = dict(kb.LAUNCHES)
    log(f"[diag] diag_rollout {n} envs x {DIAG_STEPS} steps: {counts['episodes']} episodes; "
        f"launches {counted['diag']}; {time.perf_counter() - t0:.1f} s")
    check(counted["diag"]["control_step"] == DIAG_STEPS, "diag_rollout missed K2")
    return counted


GRAPHICS_RES = (640, 480)
GRAPHICS_PORT = 18500
# the keys a browser sends through the stream's /control, after this frame
GRAPHICS_KEYS, GRAPHICS_KEY_FRAME = ("Enter", "ArrowUp", "e", "%20"), 5
GRAPHICS_EPISODE = 40    # env.episodeLength of [graphics]'s evaluations
GRAPHICS_FRAMES = 20     # frames timed for the per-frame split


def shaded_pixels(frame, color) -> int:
    """Pixels of `color` under the rasterizer's light (a shade between its
    0.35 ambient and 1), each channel within 2 levels."""
    f = frame.astype(np.float64)
    shade = f[..., 0] / (255.0 * color[0])
    ok = (shade >= 0.34) & (shade <= 1.01)
    for ch in (1, 2):
        ok &= np.abs(f[..., ch] - 255.0 * color[ch] * shade) <= 2.0
    return int(ok.sum())


def per_env_leaves(state, n) -> dict:
    """{name: tensor} of the leaves of an EnvState whose leading dim is n."""
    out = {}

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            if x.ndim and x.shape[0] == n:
                out[name] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{name}.{k}")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{name}.{f.name}")

    walk(state, "state")
    return out


def graphics_phase(dev, n, gen, cli, train_run, ckpt, card) -> dict:
    """[graphics]: the evaluation path's sidecar on the card (frames drawn
    on the host from K2's states). Returns {K2 build: launches} of its
    counted runs."""
    import urllib.request

    import cv2

    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.graphics import renderer as rmod
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    counted = {}
    # ---- frames of K2's and of the plain step's states on the same inputs
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={n}"]), seed=17, device=dev)
    c = env.comps
    ks, _ = env.reset_fn()
    ps = ks
    for _ in range(3):
        samples = env.draw_samples(n, ks.difficulty)
        acts = torch.rand(n, env.num_actions, generator=gen, device=dev) * 2 - 1
        ks, *_ = env._step(ks, acts, *samples, env._control_step)
        ps, *_ = env._step(ps, acts, *samples, env._plain_control_step)
    r = rmod.SceneRenderer(c.model, resolution=GRAPHICS_RES, box_size=c.engine.params.box_size)
    frames = [rmod.env_rows(c.engine, s_.physics, env._spawn, s_.body_contact_force, 0).render(
        r, "games 0") for s_ in (ks, ps)]
    n_px = GRAPHICS_RES[0] * GRAPHICS_RES[1]
    off = int((frames[0] != frames[1]).any(-1).sum())
    kin_all = c.engine.fk(ks.physics.q, ks.physics.qd, env._spawn.expand(n, 3))
    f_all = rmod.EnvRows.select(kin_all, ks.physics, ks.body_contact_force, 0).render(r, "games 0")
    same = bool(np.array_equal(f_all, frames[0]))
    log(f"[graphics] env 0 at {GRAPHICS_RES[0]}x{GRAPHICS_RES[1]} after 3 random steps of "
        f"{n} envs: the frame from K2's state vs the plain step's differs in {off} of {n_px} "
        f"pixels (limit {int(0.005 * n_px)}, 0.5%); FK of env 0 alone vs FK of all {n} envs: "
        f"frames bitwise equal {same}")
    check(off <= 0.005 * n_px and same and frames[0].std() > 5.0,
          "the frame of K2's state leaves the plain step's, or FK of one env differs")

    # ---- the E key's reset: the other envs' rows bitwise those of the same
    # step without it
    idx = 1
    samples = env.draw_samples(n, ks.difficulty)
    acts = torch.rand(n, env.num_actions, generator=gen, device=dev) * 2 - 1
    plain_next, *_ = env.step_fn(ks, acts, samples)
    keyed_next, *_ = env.step_fn(cli.masked_reset(env, ks, idx), acts, samples)
    a_, b_ = per_env_leaves(plain_next, n), per_env_leaves(keyed_next, n)
    others = torch.arange(n, device=dev) != idx
    other_equal = sorted(a_) == sorted(b_) and all(
        torch.equal(a_[k][others], b_[k][others]) for k in a_)
    moved = not torch.equal(a_["state.physics.q"][idx], b_["state.physics.q"][idx])
    log(f"[graphics] E key on env {idx} then one K2 step at {n} envs: the other envs' rows "
        f"({len(a_)} leaves) bitwise equal to the step without the key {other_equal}; env "
        f"{idx}'s q changed {moved}")
    check(other_equal and moved, "the E key's masked reset reached another env's rows")

    # ---- the CLI's evaluation with the viewer, the stream and the mp4; the
    # keys sent through /control as a browser sends them
    ev_args = ["task=BlindGrasping", f"numEnvs={n}", "train.logging.noLogFile=true",
               "test=true", f"checkpoint={ckpt}", f"testGamesNum={n}",
               f"env.episodeLength={GRAPHICS_EPISODE}", f"env.stream.port={GRAPHICS_PORT}"]
    after = cli.Sidecar.after_step

    def after_step(sc, state, games):
        after(sc, state, games)
        if sc.frames == GRAPHICS_KEY_FRAME:
            for k in GRAPHICS_KEYS:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{sc.streamer.port}/control?key={k}", timeout=10):
                    pass

    cli.Sidecar.after_step = after_step
    try:
        ev, ev_launches, ev_s = train_run(ev_args + [
            "env.viewer=true", "env.videoStream=true", "env.videoRecord=true"], False)
    finally:
        cli.Sidecar.after_step = after
    counted["control_step"] = ev_launches["control_step"]
    st = ev.stats[-1]
    sc = st["sidecar"]
    mp4 = os.path.join(ev.run_dir, "videos", "episode_00001.mp4")
    mp4_bytes = os.path.getsize(mp4) if os.path.exists(mp4) else 0
    n_ep = max(1, st["episodes"])
    reasons = ", ".join(f"{k.replace('_reason_', ':')} {v / n_ep:.3f}"
                        for k, v in sorted(st["reasons"].items()) if v) or "none fired"
    log(f"[graphics] CLI evaluation, viewer + stream + mp4, {n} envs, episodeLength "
        f"{GRAPHICS_EPISODE}, paced to control_dt {ev.env.control_dt:.3f} s: {st['episodes']} "
        f"episodes in {sc['frames']} steps, {ev_s:.2f} s; keys {GRAPHICS_KEYS} through /control "
        f"after frame {GRAPHICS_KEY_FRAME}: view mode {sc['view_mode']}, selected env "
        f"{sc['selected_env']}, random actions {sc['random_actions']}, E-key resets "
        f"{sc['resets']}; /stats frames_received {sc['stream']['frames_received']}, keys_received "
        f"{sc['stream'].get('keys_received')}; {os.path.relpath(mp4, ROOT)} {mp4_bytes} bytes; "
        f"launches {ev_launches}")
    log(f"[graphics] termination reasons over {st['episodes']} episodes (success {st['success']}, "
        f"failure {st['failure']}, timeout {st['timeout']}): {reasons}")
    check((sc["view_mode"], sc["selected_env"], sc["random_actions"], sc["resets"])
          == (1, 1, True, [1]), f"the keys did not act as the key table says: {sc}")
    check(ev_launches["control_step"] == sc["frames"] == sc["stream"]["frames_received"]
          and st["episodes"] >= n and mp4_bytes > 1000,
          "evaluation's K2 launches, frames and stream disagree, or the mp4 is missing")

    # ---- evaluation env-steps/s with the sidecar off and on (no viewer, so
    # no pacing; the same steps)
    rates = {}
    for label, extra in (("off", []), ("on", ["env.videoStream=true", "env.videoRecord=true"])):
        run, launches, secs = train_run(ev_args + extra, False)
        rates[label] = (launches["control_step"], launches["control_step"] * n / secs, secs)
    log(f"[graphics] evaluation, {n} envs, {rates['off'][0]} steps: sidecar off "
        f"{rates['off'][1]:,.0f} env-steps/s ({rates['off'][2]:.2f} s), on (mp4 + MJPEG of env "
        f"0 each step) {rates['on'][1]:,.0f} env-steps/s ({rates['on'][2]:.2f} s) ({card})")
    check(rates["off"][0] == rates["on"][0], f"the two evaluations took other steps: {rates}")

    # ---- ms per frame: FK of env 0 and its copy to the host, rasterizing,
    # encoding (JPEG as the stream, mp4v as the recorder)
    def per_call_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(GRAPHICS_FRAMES):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / GRAPHICS_FRAMES, out

    fk_ms, rows = per_call_ms(lambda: rmod.env_rows(c.engine, ks.physics, env._spawn,
                                                     ks.body_contact_force, 0))
    raster_ms, frame = per_call_ms(lambda: rows.render(r, "games 0"))
    jpeg_ms, _ = per_call_ms(lambda: cv2.imencode(".jpg", frame[..., ::-1],
                                                  [int(cv2.IMWRITE_JPEG_QUALITY), 80]))
    probe = os.path.join(ROOT, "runs_all", "graphics_probe.mp4")
    writer = cv2.VideoWriter(probe, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, GRAPHICS_RES)
    mp4_ms, _ = per_call_ms(lambda: writer.write(frame[..., ::-1]))
    writer.release()
    log(f"[graphics] ms per frame at {GRAPHICS_RES[0]}x{GRAPHICS_RES[1]} (mean of "
        f"{GRAPHICS_FRAMES}, host clock): FK of env 0 on the card + copy to the host "
        f"{fk_ms:.2f}, rasterizing {raster_ms:.2f}, JPEG {jpeg_ms:.2f}, mp4v {mp4_ms:.2f} ({card})")

    # ---- BoxStacking: the second box through K2's two-box build
    env_st = make_env(load_config(["task=BoxStacking", f"numEnvs={n}"]), seed=17, device=dev)
    env_st.reset()
    torch.cuda.synchronize()
    kb.reset_launches()
    for _ in range(10):
        env_st.step(torch.rand(n, env_st.num_actions, generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    counted["control_step_box2"] = kb.LAUNCHES["control_step_box2"]
    c_st = env_st.comps
    r_st = rmod.SceneRenderer(c_st.model, resolution=GRAPHICS_RES,
                              box_size=c_st.engine.params.box_size)
    rows_st = rmod.env_rows(c_st.engine, env_st.state.physics, env_st._spawn,
                            env_st.state.body_contact_force, 0)
    box2_size = c_st.engine.params.box2_size
    with_box2 = shaded_pixels(rows_st.render(r_st, "env 0", box2_size=box2_size), rmod.BOX2_COLOR)
    without = shaded_pixels(dataclasses.replace(rows_st, box2_pos=None).render(r_st, "env 0"),
                            rmod.BOX2_COLOR)
    log(f"[graphics] BoxStacking, {n} envs, 10 unfused steps: launches "
        f"{counted['control_step_box2']} of control_step_box2; env 0's frame holds {with_box2} "
        f"pixels of the second box's colour {rmod.BOX2_COLOR} shaded ({without} without it)")
    check(counted["control_step_box2"] == 10 and with_box2 - without >= 50,
          "BoxStacking's evaluation missed K2's two-box build or did not draw the second box")
    log(f"[graphics] phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return counted


TOOLS_BENCH_STEPS = 48   # the bench entry's steps per window in [tools]
TOOLS_CORIOLIS_S = 0.1   # measure_coriolis's sweep in [tools], seconds
UPDATE_PARTS_TOL = 0.10  # the update split's parts against its iteration


def tools_phase(dev, n: int, card: str) -> dict:
    """[tools]: the measurement tools on the card, each through its entry
    point: the bench as a subprocess, the others in this process with their
    output captured and logged. Returns {kernel build: launches} of the
    phase (the bench subprocess's included)."""
    import contextlib
    import io
    import subprocess
    import tempfile

    from dexrobot_isaac_tpu_torch.tools import (
        bench_kernel,
        bench_train_anatomy,
        bench_update_anatomy,
        measure_coriolis,
        record_golden,
        roofline,
    )

    t_phase = time.perf_counter()
    counted = {k: 0 for k in kb.LAUNCHES}
    # ---- the bench entry, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dexrobot_isaac_tpu_torch.bench", str(n),
                           str(TOOLS_BENCH_STEPS), *(["device=cpu"] if dev.type == "cpu" else [])],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    for ln in proc.stderr.strip().splitlines()[-20:]:
        log(f"[tools] bench stderr: {ln}")
    check(proc.returncode == 0, f"the bench entry exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[tools] bench: {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
    keys = ("metric", "value", "unit", "vs_baseline", "median_of_5", "flops_per_env_step",
            "achieved_flops_per_s", "mfu", "f32_mfu")
    check(all(k in line for k in keys) and line["value"] > 0 and line["median_of_5"] > 0
          and 0 < line["f32_mfu"] <= 1 and 0 < line["mfu"] <= 1,
          f"the bench's line lacks a key or holds an impossible number: {line}")
    paths = next(ln for ln in proc.stderr.splitlines() if ln.startswith("paths"))
    bench_launches = json.loads(next(ln for ln in proc.stderr.splitlines()
                                     if ln.startswith("launches")).split(": ", 1)[1])
    steps = 16 + 5 * TOOLS_BENCH_STEPS  # a warm-up chunk and 5 windows
    check(" fused=" in paths and " unfused=" in paths
          and bench_launches.get("fused_step") == steps
          and bench_launches.get("control_step") == steps,
          f"the bench did not time both paths through K1 and K2: {paths}; {bench_launches}")
    for k, v in bench_launches.items():
        counted[k] += v

    def tool(name, fn, *a, **kw):
        before = dict(kb.LAUNCHES)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fn(*a, **kw)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in kb.LAUNCHES.items() if v > before[k]}
        for ln in buf.getvalue().splitlines():
            log(f"[tools] {name}: {ln}")
        log(f"[tools] {name}: {time.perf_counter() - t0:.1f} s, launches {used}")
        for k, v in used.items():
            counted[k] += v
        return res, used, buf.getvalue()

    # ---- the update anatomy: every config, and the split of the baseline
    upd, _, text = tool("update anatomy", bench_update_anatomy.run, n, dev)
    parts = upd["split"]
    summed = sum(parts[p] for p, _ in bench_update_anatomy.PARTS)
    check(all(f"{tag:42s}:" in text for tag, _ in bench_update_anatomy.CONFIGS)
          and all(ms > 0 and np.isfinite(kl) for ms, kl in upd["configs"].values()),
          f"the update anatomy missed a config or went non-finite: {upd['configs']}")
    check(abs(summed - parts["iteration"]) <= UPDATE_PARTS_TOL * parts["iteration"],
          f"the update's parts sum to {summed:.2f} ms of a {parts['iteration']:.2f} ms iteration")
    # ---- the training anatomy on K1, one chunk depth
    tr, tr_used, text = tool("train anatomy", bench_train_anatomy.run, n, ("permutation",), (8,),
                             dev)
    horizon = 16
    k1_expected = horizon * (3 * (1 + 5) + (1 + 3) * 8)
    check(len(tr) == 4 and all(v > 0 for v in tr.values())
          and tr_used.get("fused_step") == k1_expected,
          f"the train anatomy missed a line or K1 ({k1_expected} launches): {tr}, {tr_used}")
    # ---- K2 alone at two widths
    kern, kern_used, _ = tool("bench_kernel", bench_kernel.run, (n, 2 * n), 50, dev)
    check(len(kern) == 2 and kern_used.get("control_step", 0) >= 2 * 51
          and all(k["value"] > 0 and (k["device_ms_per_launch"] or 0) > 0 for k in kern),
          f"bench_kernel missed K2: {kern}, {kern_used}")
    # ---- K1's roofline at the bench's rate
    roof, _, _ = tool("roofline", roofline.run, n, line["value"], dev, line["flops_per_env_step"])
    check(0 < roof["hbm_share"] < 1 and 0 < roof["f32_share"] <= 1
          and 0 < roof["k1_f32_share"] <= 1, f"the roofline's shares are impossible: {roof}")
    # ---- the Coriolis measurement through K3
    cor, cor_used, _ = tool("measure_coriolis", measure_coriolis.run, TOOLS_CORIOLIS_S, dev)
    n_solves = round(TOOLS_CORIOLIS_S / 0.005) * 3 * 4  # 3 physics steps per step, 4 substeps
    check(cor_used.get("spd_solve") == n_solves and all(
        np.isfinite(list(r.values())).all() and r["dqd_max"] > 0 for r in cor.values()),
        f"measure_coriolis missed K3 ({n_solves} solves) or went non-finite: {cor}, {cor_used}")
    # ---- the golden scenario recorded from K1, replayed against the TPU's
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k1_golden.npz")
        _, rec_used, _ = tool("record_golden", record_golden.write, path, dev)
        rec = dict(np.load(path))
    golden = dict(np.load(GOLDEN))
    same = all(rec[k].shape == golden[k].shape and rec[k].dtype == golden[k].dtype
               for k in golden) and sorted(rec) == sorted(golden)
    err = record_golden.golden_errors(rec)
    log(f"[tools] record_golden: keys, shapes and dtypes as the TPU golden's {same}; against it "
        f"done equal {err['done']}, max abs err obs {err['obs']:.3e} (atol 2e-4) rew "
        f"{err['rew']:.3e} (atol 1e-3) comp {err['comp']:.3e} (atol 1e-3)")
    check(same and err["done"] and all(err[k] <= b for k, b in record_golden.BUDGETS.items())
          and rec_used.get("fused_step") == record_golden.STEPS,
          "record_golden's npz from K1 misses the TPU golden")
    log(f"[tools] phase {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: v for k, v in counted.items() if v} } ({card})")
    return {k: v for k, v in counted.items() if v}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dexrobot_isaac_tpu_torch import train as cli
    from dexrobot_isaac_tpu_torch.envs import fused_step
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.ops import linalg
    from dexrobot_isaac_tpu_torch.physics import lane_step
    from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics
    from dexrobot_isaac_tpu_torch.physics.types import box_rows
    from dexrobot_isaac_tpu_torch.tools.roofline import bound, nbytes
    from dexrobot_isaac_tpu_torch.utils import kernel_build
    from dexrobot_isaac_tpu_torch.utils.config import load_config
    from dexrobot_isaac_tpu_torch.utils.lane_probe import contact_counts, stacked_scene

    global kb
    kb = kernel_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = kb.card()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------------- 1 build
    secs = kb.build_all()
    log(f"[build] nvcc seconds: {json.dumps({k: round(v, 1) for k, v in secs.items()})}")
    for name in kb.BUILDS:
        with open(kb.lib_path(name) + ".ptxas.txt") as f:
            for line in kb.ptxas_lines(f.read()):
                log(f"[build] {name}: {line}")
    occ = occupancy(kb, lane_step)
    unit = lambda k: "systems" if k == "spd_solve" else "envs"
    log("[build] occupancy (a half-warp per env, a warp per K3 system): " + "; ".join(
        f"{k} {smem} B shared per block of {per} {unit(k)}, {blocks} blocks = {blocks * per} "
        f"{unit(k)} resident per SM" for k, (smem, blocks, per) in occ.items()))
    check(all(b >= 1 for _, b, _ in occ.values()), f"a kernel cannot be resident: {occ}")
    lane_builds = [k for k in kb.BUILDS if kb.BUILDS[k][0] in ("control_step", "fused_step")]
    check(all(occ[k][1] * occ[k][2] == 32 for k in lane_builds),
          f"a K1 or K2 build does not hold 32 envs per SM: {occ}")

    # ---------------------------------------------------------------- 2 golden
    golden = dict(np.load(GOLDEN))
    ops = {k: torch.as_tensor(v, device=dev) for k, v in np.load(
        os.path.join(ROOT, "dexrobot_isaac_tpu_torch", "data", "golden_operands.npz")).items()}
    env = make_env(load_config(GOLDEN_CONFIG), seed=GOLDEN_SEED, device=dev)
    fused = env.make_fused()
    fs, _ = fused.reset(samples=(fused.reset_from_rows(ops["init_rst"]), None))
    got = {k: [] for k in ("obs", "rew", "done", "comp")}
    for t in range(ops["actions"].shape[0]):
        fs, obs, rew, done, ex = fused.step_fn(fs, ops["actions"][t],
                                              operands=(ops["rst"][t], ops["drn"][t]))
        for k, v in (("obs", obs), ("rew", rew), ("done", done),
                     ("comp", ex["reward_components_packed"])):
            got[k].append(v.cpu().numpy())
    got = {k: np.stack(v) for k, v in got.items()}
    gerr = {k: float(np.abs(got[k] - golden[k]).max()) for k in ("obs", "rew", "comp")}
    done_ok = bool(np.array_equal(got["done"], golden["done"]))
    log(f"[golden] K1 (CUDA) vs TPU recording, 12 steps x 8 envs: done equal {done_ok}, "
        f"max abs err obs {gerr['obs']:.3e} (atol 2e-4) rew {gerr['rew']:.3e} (atol 1e-3) "
        f"comp {gerr['comp']:.3e} (atol 1e-3)")
    check(done_ok and gerr["obs"] <= 2e-4 and gerr["rew"] <= 1e-3 and gerr["comp"] <= 1e-3,
          "golden replay through the CUDA fused kernel missed its tolerances")

    # ---------------------------------------------------------------- 3 K2
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={N_ENVS}"]), seed=7, device=dev)
    c = env.comps
    fused = env.make_fused()
    gen = torch.Generator(device=dev).manual_seed(11)
    state, _ = env.reset_fn()
    t0 = time.perf_counter()
    for _ in range(3):  # plain steps of random actions: a contact-rich state
        samples = env.draw_samples(N_ENVS, state.difficulty)
        acts = torch.rand(N_ENVS, env.num_actions, generator=gen, device=dev) * 2 - 1
        state, *_ = env._step(state, acts, *samples, env._plain_control_step)
    torch.cuda.synchronize()
    log(f"[K2] 3 plain steps at {N_ENVS} envs: {time.perf_counter() - t0:.1f} s")
    spawn = env._spawn.expand(N_ENVS, 3)
    ph, tgt, dr = state.physics, state.full_dof_targets, state.dr
    kernel_cs = lane_step.build_control_step(c.engine, c.physics_steps_per_control)
    plain_cs = c.engine.plain_control_step(c.physics_steps_per_control)
    kst, kinfo, kkin = kernel_cs(ph, tgt, spawn, dr)
    pst, pinfo, pkin = plain_cs(ph, tgt, spawn, dr)
    torch.cuda.synchronize()
    box = lambda s: torch.cat([s.box_pos, s.box_quat, s.box_linvel, s.box_angvel], 1)
    k2 = {
        "q": rel_err(kst.q, pst.q), "qd": rel_err(kst.qd, pst.qd),
        "box": rel_err(box(kst), box(pst)),
        "body_pos": rel_err(kkin.body_pos, pkin.body_pos),
        "site_pos": rel_err(kkin.site_pos, pkin.site_pos),
        "body_linvel": rel_err(kkin.body_linvel, pkin.body_linvel),
        "contact_force": rel_err(kinfo.body_contact_force, pinfo.body_contact_force),
        "box_force": rel_err(kinfo.box_contact_force, pinfo.box_contact_force),
    }
    k2_abs = max(float((a - b).abs().max()) for a, b in
                 ((kst.q, pst.q), (kst.qd, pst.qd), (box(kst), box(pst))))
    n_contact = int((pinfo.body_contact_force.abs().sum((1, 2)) > 0).sum())
    log(f"[K2] control step vs plain at {N_ENVS} envs ({n_contact} envs in hand contact): "
        "relative err " + " ".join(f"{k} {v:.2e}" for k, v in k2.items()))
    check(all(v <= 1e-3 for v in k2.values()), "K2 disagrees with the plain engine beyond 1e-3")
    tips = [int(x) for x in c.obs_cfg.fingertip_site_indices]
    mz_k = lane_step.min_site_z(c.engine, ph.q, env._spawn, tips)
    mz_p = c.engine.min_site_z(ph.q, spawn, tips)
    mz_err = float((mz_k - mz_p).abs().max())
    log(f"[K2] min_site_z vs plain on {N_ENVS} poses: max abs err {mz_err:.3e} (atol 1e-5)")
    check(mz_err <= 1e-5, "min_site_z disagrees with the plain FK")

    # ---------------------------------------------------------------- 4 K1
    # K1's inputs (timed again in phase 9): phase 3's state, every other env
    # at its last episode step, so the step's reset merge and spawn
    # projection run on half the envs
    k1, (fs_k1, (act_T, rst, drn, spw)), ko, n_done, _ = k1_vs_plain(fused, env, state, gen,
                                                                     dev, N_ENVS)
    log(f"[K1] two launches on the same inputs bitwise equal: {k1['bitwise']}")
    check(k1["bitwise"], "K1 gave different bits on the same inputs")
    log(f"[K1] fused step vs plain at {N_ENVS} envs: mask mismatches {k1['mask_mismatches']} "
        f"(dones {n_done}); where masks agree max abs err obs {k1['obs']:.3e} "
        f"rew {k1['rew']:.3e} comp {k1['comp']:.3e}, rows_f rel {k1['rows_f']:.2e}, "
        f"rows_i equal {k1['rows_i_equal']}")
    check(k1["mask_mismatches"] <= N_ENVS // 100 and n_done >= N_ENVS // 2 and k1["obs"] <= 2e-4
          and k1["rew"] <= 1e-3 and k1["comp"] <= 1e-3 and k1["rows_f"] <= 1e-3
          and k1["rows_i_equal"], "K1 disagrees with the plain fused step")

    # ---------------------------------------------------------------- box2
    env_st = make_env(load_config(["task=BoxStacking", f"numEnvs={N_ENVS}"]), seed=7, device=dev)
    c_st = env_st.comps
    fused_st = env_st.make_fused()
    t0 = time.perf_counter()
    state_st = plain_steps(env_st, gen, dev, N_ENVS, 3)
    ph_st = stacked_scene(env_st, state_st, gen)
    state_st = dataclasses.replace(state_st, physics=ph_st)
    torch.cuda.synchronize()
    log(f"[box2] 3 plain BoxStacking steps at {N_ENVS} envs: {time.perf_counter() - t0:.1f} s")
    tgt_st, dr_st = state_st.full_dof_targets, state_st.dr
    steps_st = c_st.physics_steps_per_control
    cs_box2 = lane_step.build_control_step(c_st.engine, steps_st)
    kst2, kinfo2, kkin2 = cs_box2(ph_st, tgt_st, spawn, dr_st)
    kst2b, kinfo2b, _ = cs_box2(ph_st, tgt_st, spawn, dr_st)
    plain_st = c_st.engine.plain_control_step(steps_st)
    pst2, pinfo2, pkin2 = plain_st(ph_st, tgt_st, spawn, dr_st)
    torch.cuda.synchronize()
    boxes = lambda s_: box_rows(s_, True)
    bforce = lambda i: torch.cat([i.box_contact_force, i.box2_contact_force], 1)
    box2_bits = all(torch.equal(a_, b_) for a_, b_ in (
        (kst2.q, kst2b.q), (kst2.qd, kst2b.qd), (boxes(kst2), boxes(kst2b)),
        (bforce(kinfo2), bforce(kinfo2b)),
        (kinfo2.body_contact_force, kinfo2b.body_contact_force)))
    k2b = {"q": rel_err(kst2.q, pst2.q), "qd": rel_err(kst2.qd, pst2.qd),
           "box": rel_err(boxes(kst2)[:, :13], boxes(pst2)[:, :13]),
           "box2": rel_err(boxes(kst2)[:, 13:], boxes(pst2)[:, 13:]),
           "box_force": rel_err(kinfo2.box_contact_force, pinfo2.box_contact_force),
           "box2_force": rel_err(kinfo2.box2_contact_force, pinfo2.box2_contact_force),
           "contact_force": rel_err(kinfo2.body_contact_force, pinfo2.body_contact_force),
           "site_pos": rel_err(kkin2.site_pos, pkin2.site_pos)}
    k2b_abs = max(float((a_ - b_).abs().max()) for a_, b_ in
                  ((kst2.q, pst2.q), (kst2.qd, pst2.qd), (boxes(kst2), boxes(pst2))))
    n_cube, n_plat = contact_counts(c_st.engine, ph_st, dr_st)
    n_hand = int((pinfo2.body_contact_force.abs().sum((1, 2)) > 0).sum())
    log(f"[box2] K2 two-box build vs plain at {N_ENVS} envs ({n_cube} envs with cube-cube "
        f"contact, {n_plat} with the platform on the ground, {n_hand} in hand contact): "
        "relative err " + " ".join(f"{k} {v:.2e}" for k, v in k2b.items())
        + f"; two launches bitwise equal: {box2_bits}")
    check(all(v <= 1e-3 for v in k2b.values()) and box2_bits and n_cube > 0 and n_plat > 0
          and n_hand > 0, "K2's two-box build disagrees with the plain engine, is not bitwise "
          "stable, or the state lacks a contact kind")

    # ---------------------------------------------------------------- stacking, base, tasks, recipe
    # each K1 task build against its plain version (timed again in phase 9),
    # then the BlindGrasping build on the README recipe at its 8192 envs and
    # on BlindGraspingClearance (not timed)
    k1_runs = {}
    fused_builds_timed = ("stacking", "base", *NEW_TASKS.values())
    scenes = [("stacking", lambda: (env_st, fused_st, state_st)),
              ("base", lambda: _task_env(make_env, load_config, gen, dev, ["task=BaseTask"], k=2))]
    scenes += [(build, lambda t=task: _task_env(make_env, load_config, gen, dev, [f"task={t}"]))
               for task, build in NEW_TASKS.items()]
    # InHandReorientation's pinch is ill-conditioned over a control step's 16
    # substeps: the plain version, run on the host's CPU instead of the card,
    # already leaves K1's tolerances in a few envs (`plain_spread`). Its
    # build is held at the tolerances in every env with one substep per
    # launch, and at 16 substeps in all but at most 1% of the envs, beside
    # the plain version's own spread.
    scenes.insert(4, ("fused_step_inhand 1 substep", lambda: _task_env(
        make_env, load_config, gen, dev, ["task=InHandReorientation"] + ONE_SUBSTEP)))
    scenes += [(f"recipe {exp} x {n}", lambda e=exp, n=n: _task_env(
        make_env, load_config, gen, dev, [f"experiments={e}"], n=n))
        for exp, n in (("BlindGraspingCurriculum", 2 * N_ENVS),
                       ("BlindGraspingClearance", N_ENVS))]
    for label, scene in scenes:
        t0 = time.perf_counter()
        env_t, fused_t, state_t = scene()
        n_t = state_t.physics.q.shape[0]
        err, ins_t, ko_t, done_t, plain_t = k1_vs_plain(fused_t, env_t, state_t, gen, dev, n_t)
        phase = ("recipe" if label.startswith("recipe") else
                 "tasks" if label.split()[0] in NEW_TASKS.values() else label)
        ill = label == "fused_step_inhand"
        spread = ""
        if ill:
            n_spread = int(plain_spread(["task=InHandReorientation"], *ins_t, plain_t).sum())
            spread = f"; the plain version on the CPU against the card: {n_spread} envs beyond them"
        log(f"[{phase}] K1 {fused_t.build} vs plain at {n_t} envs "
            f"({label}, obs {fused_t.obs_dim}, {len(fused_t.comp_names)} components): mask "
            f"mismatches {err['mask_mismatches']} (dones {done_t}); max abs err obs "
            f"{err['obs']:.3e} (atol 2e-4) rew {err['rew']:.3e} (atol 1e-3) comp "
            f"{err['comp']:.3e}, rows_f rel {err['rows_f']:.2e}, rows_i equal "
            f"{err['rows_i_equal']}; envs beyond the tolerances {err['envs_off']}{spread}; "
            f"two launches bitwise equal {err['bitwise']}; {time.perf_counter() - t0:.1f} s")
        check(err["mask_mismatches"] == 0 and done_t >= n_t // 2 and err["bitwise"]
              and err["envs_off"] <= (n_t // 100 if ill else 0),
              f"K1's {fused_t.build} build disagrees with the plain fused step ({label})")
        if phase != "recipe" and label in fused_builds_timed:
            k1_runs[label] = (env_t, fused_t, err, ins_t, ko_t, done_t)

    # ---------------------------------------------------------------- 5 K3
    eng_c = HandPhysics(model=c.model, params=dataclasses.replace(c.engine.params, coriolis=True),
                        device=dev)
    systems = []

    def capture(A, b):
        systems.append((A, b))
        return linalg.spd_solve_plain(A, b)

    eng_c._substep(ph, tgt, spawn, dr, capture)  # one Coriolis substep's systems
    A3, b3 = systems[0]
    x_k3 = linalg.spd_solve(A3, b3)
    x_k3b = linalg.spd_solve(A3, b3)
    x_p3 = linalg.spd_solve_plain(A3, b3)
    x_64 = torch.linalg.solve(A3.double(), b3.double()[..., None])[..., 0]
    torch.cuda.synchronize()
    k3_err = rel_err(x_k3, x_p3)
    k3_abs = float((x_k3 - x_p3).abs().max())
    k3_bits = bool(torch.equal(x_k3, x_k3b))
    log(f"[K3] spd_solve vs plain on {N_ENVS} systems (26x26) of one Coriolis substep: "
        f"relative err {k3_err:.2e} (tol 1e-5); against float64: kernel "
        f"{rel_err(x_k3.double(), x_64):.2e}, plain {rel_err(x_p3.double(), x_64):.2e}; "
        f"two launches bitwise equal: {k3_bits}")
    check(k3_err <= 1e-5 and k3_bits, "K3 disagrees with the plain SPD solve beyond 1e-5, "
          "or gave different bits on the same inputs")
    for n3 in (N_ENVS - 1, 1):  # a ragged last block, and a lone system
        e3 = rel_err(linalg.spd_solve(A3[:n3], b3[:n3]), linalg.spd_solve_plain(A3[:n3], b3[:n3]))
        log(f"[K3] spd_solve vs plain on the first {n3} of them: relative err {e3:.2e} (tol 1e-5)")
        check(e3 <= 1e-5, f"K3 disagrees with the plain SPD solve on {n3} systems")

    # ---------------------------------------------------------------- 6 coriolis
    cor_k = eng_c.make_control_step(c.physics_steps_per_control)
    cor_p = eng_c.plain_control_step(c.physics_steps_per_control)
    kb.reset_launches()
    cst, cinfo, _ = cor_k(ph, tgt, spawn, dr)
    torch.cuda.synchronize()
    cor_launches = kb.LAUNCHES["spd_solve"]
    pcst, pcinfo, _ = cor_p(ph, tgt, spawn, dr)
    torch.cuda.synchronize()
    cor = {"q": rel_err(cst.q, pcst.q), "qd": rel_err(cst.qd, pcst.qd),
           "box": rel_err(box(cst), box(pcst)),
           "contact_force": rel_err(cinfo.body_contact_force, pcinfo.body_contact_force)}
    cor_vs_k2 = rel_err(pcst.qd, pst.qd)
    log(f"[coriolis] control step through K3 vs the plain Coriolis sequence at {N_ENVS} envs: "
        "relative err " + " ".join(f"{k} {v:.2e}" for k, v in cor.items())
        + f"; spd_solve launches {cor_launches}; qd with vs without the bias differs by "
        f"{cor_vs_k2:.2e} relative")
    check(all(v <= 1e-3 for v in cor.values()) and cor_launches == 16,
          "the Coriolis control step through K3 disagrees with its plain version")

    # ---------------------------------------------------------------- clip_adam
    adam = clip_adam_phase(dev, card)

    # ---------------------------------------------------------------- 7 main path
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={N_ENVS}"]), seed=42, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fused = env.make_fused()
    sps, n_dones, finite, obs_shape, launches = rollout(env, fused, gen, dev, N_ENVS,
                                                       ROLLOUT_STEPS, 10)
    log(f"[main] {ROLLOUT_STEPS} fused steps x {N_ENVS} envs = {sps:,.0f} env-steps/s; dones "
        f"{n_dones}; finite {finite}; obs {obs_shape}; launches {launches}")
    check(finite and n_dones > 0 and obs_shape == (N_ENVS, fused.obs_dim),
          "rollout output not finite, of the wrong shape, or without a done")
    check(launches["fused_step"] == ROLLOUT_STEPS and launches["control_step"] == 10
          and launches["min_site_z"] >= 1, f"main path missed a kernel: {launches}")
    # BoxStacking's and BaseTask's paths, each counted on its own
    path_sps = {}
    for label, task, steps, k1_build, k2_build in (
            ("stacking", "BoxStacking", ROLLOUT_STEPS, "fused_step_stacking", "control_step_box2"),
            ("base", "BaseTask", 100, "fused_step_base", "control_step"),
            *((build, task, TASK_STEPS, build, "control_step")
              for task, build in NEW_TASKS.items())):
        env_p = make_env(load_config([f"task={task}", f"numEnvs={N_ENVS}"]), seed=42, device=dev)
        fused_p = env_p.make_fused()
        sps_p, dones_p, finite_p, shape_p, counts = rollout(env_p, fused_p, gen, dev, N_ENVS,
                                                            steps, 10)
        path_sps[label] = sps_p
        launches[k1_build] = counts[k1_build]
        if k2_build != "control_step":
            launches[k2_build] = counts[k2_build]
        log(f"[{label}] {task}: {steps} fused steps x {N_ENVS} envs = {sps_p:,.0f} env-steps/s; "
            f"dones {dones_p}; finite {finite_p}; obs {shape_p}; launches {counts}")
        check(finite_p and shape_p == (N_ENVS, fused_p.obs_dim) and counts[k1_build] == steps
              and counts[k2_build] == 10, f"the {task} path missed a kernel: {counts}")
        check(label == "base" or dones_p > 0, f"the {task} rollout had no done")

    # ---------------------------------------------------------------- 8 train
    # the CLI trainer in-process; run directories under ROOT/runs_all
    os.environ["DEXHAND_RUNS_DIR"] = ROOT
    base = ["task=BlindGrasping", f"numEnvs={N_ENVS}", "train.logging.noLogFile=true",
            "train.params.config.log_interval=1"]

    def train_run(args, expect_fused):
        sess = cli.build(load_config(args if args[0].startswith("task=") else base + args))
        check((sess.fused is not None) == expect_fused, f"fused step choice for {args}")
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        rc = cli.run_test(sess) if sess.test_mode else cli.run_train(sess)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(kb.LAUNCHES)
        check(rc == 0, f"the CLI run {args} returned {rc}")
        return sess, counts, secs

    horizon = 16
    tr, tr_launches, tr_s = train_run(["maxIterations=3", "train.params.config.save_frequency=3"],
                                      True)
    finite_params = lambda sess: all(bool(torch.isfinite(v).all())
                                     for v in sess.ppo.params.values())
    for st in tr.stats:
        log(f"[train] fused iteration {st['iteration']}: {st['env_steps_per_s']:,.0f} env-steps/s,"
            f" rollout {st['rollout_s'] * 1e3:.1f} ms, update {st['update_s'] * 1e3:.1f} ms "
            f"(device time between CUDA events); kl {st['kl']:.4f}, reward {st['reward_mean']:.3f}")
    steady = tr.stats[1:]
    train_sps = sum(st["env_steps_per_s"] for st in steady) / len(steady)
    log(f"[train] 3 fused iterations x {horizon} steps x {N_ENVS} envs in {tr_s:.2f} s; steady "
        f"(iterations 2-3) {train_sps:,.0f} env-steps/s; launches {tr_launches}")
    tr_updates = 3 * tr.learner.cfg.mini_epochs * max(
        1, tr.learner.cfg.batch_size // tr.learner.cfg.minibatch)
    check(tr_launches["fused_step"] == 3 * horizon and finite_params(tr)
          and tr_launches["clip_adam"] == 2 * tr_updates
          and all(np.isfinite(list(st.values())).all() for st in tr.stats),
          f"fused training missed K1 or the clip + Adam kernel ({tr_updates} updates), or "
          f"went non-finite: {tr_launches}")
    ckpt = os.path.join(tr.run_dir, "nn", "latest.pt")

    co, co_launches, co_s = train_run(["maxIterations=1", "sim.coriolis=true",
                                       "train.params.config.fused=off"], False)
    cst_ = co.stats[-1]
    log(f"[train] Coriolis iteration (unfused, K3): {co_s:.2f} s, "
        f"{cst_['env_steps_per_s']:,.0f} env-steps/s, rollout {cst_['rollout_s'] * 1e3:.1f} ms, "
        f"update {cst_['update_s'] * 1e3:.1f} ms; kl {cst_['kl']:.4f}, reward "
        f"{cst_['reward_mean']:.3f}; launches {co_launches}")
    check(co_launches["spd_solve"] == horizon * 16 and co_launches["fused_step"] == 0
          and finite_params(co) and np.isfinite(list(cst_.values())).all(),
          f"the Coriolis iteration missed K3 or went non-finite: {co_launches}")

    ev, ev_launches, ev_s = train_run(["test=true", f"checkpoint={ckpt}",
                                       f"testGamesNum={N_ENVS}", "env.episodeLength=4"], False)
    log(f"[train] eval from {os.path.relpath(ckpt, ROOT)}: {ev.stats[-1]} in {ev_s:.2f} s; "
        f"launches {ev_launches}")
    check(ev_launches["control_step"] > 0 and ev.stats[-1]["episodes"] >= N_ENVS,
          f"evaluation missed K2: {ev_launches}")

    # BoxStacking through the CLI: fused=auto takes K1's BoxStacking build;
    # its config's dispatch chunking runs (one chunk of 2 iterations)
    base_st = ["task=BoxStacking", f"numEnvs={N_ENVS}", "train.logging.noLogFile=true",
               "train.params.config.log_interval=1"]
    st, st_launches, st_s = train_run(base_st + [
        "maxIterations=2", "train.params.config.dispatch_chunk=2",
        "train.params.config.save_frequency=2"], True)
    h_st = st.learner.cfg.horizon_length
    for s_ in st.stats:
        log(f"[stacking] train, iterations 1-{s_['iteration']}: {s_['env_steps_per_s']:,.0f} "
            f"env-steps/s, last rollout {s_['rollout_s'] * 1e3:.1f} ms, update "
            f"{s_['update_s'] * 1e3:.1f} ms; kl {s_['kl']:.4f}, reward {s_['reward_mean']:.3f}")
    log(f"[stacking] 2 PPO iterations x {h_st} steps x {N_ENVS} envs through the CLI in "
        f"{st_s:.2f} s; launches {st_launches}")
    check(st_launches["fused_step_stacking"] == 2 * h_st and finite_params(st)
          and all(np.isfinite(list(s_.values())).all() for s_ in st.stats),
          f"BoxStacking training missed K1 or went non-finite: {st_launches}")
    ckpt_st = os.path.join(st.run_dir, "nn", "latest.pt")
    sev, sev_launches, sev_s = train_run(base_st + [
        "test=true", f"checkpoint={ckpt_st}", f"testGamesNum={N_ENVS}", "env.episodeLength=4"],
        False)
    log(f"[stacking] eval from {os.path.relpath(ckpt_st, ROOT)}: {sev.stats[-1]} in "
        f"{sev_s:.2f} s; launches {sev_launches}")
    check(sev_launches["control_step_box2"] > 0 and sev.stats[-1]["episodes"] >= N_ENVS,
          f"BoxStacking evaluation missed K2's two-box build: {sev_launches}")

    # the single-box tasks through the CLI: one iteration each with
    # fused=auto (their K1 builds), then an evaluation from the
    # InHandReorientation checkpoint (the unfused step: K2)
    ckpts = {}
    for task, build in NEW_TASKS.items():
        base_t = [f"task={task}", f"numEnvs={N_ENVS}", "train.logging.noLogFile=true",
                  "train.params.config.log_interval=1"]
        tt, tt_launches, tt_s = train_run(base_t + [
            "maxIterations=1", "train.params.config.save_frequency=1"], True)
        s_ = tt.stats[-1]
        h_t = tt.learner.cfg.horizon_length
        log(f"[train] {task}: 1 PPO iteration x {h_t} steps x {N_ENVS} envs through the CLI in "
            f"{tt_s:.2f} s, {s_['env_steps_per_s']:,.0f} env-steps/s, rollout "
            f"{s_['rollout_s'] * 1e3:.1f} ms, update {s_['update_s'] * 1e3:.1f} ms; kl "
            f"{s_['kl']:.4f}, reward {s_['reward_mean']:.3f}; launches {tt_launches}")
        check(tt.fused.build == build and tt_launches[build] == h_t and finite_params(tt)
              and np.isfinite(list(s_.values())).all(),
              f"{task} training missed its K1 build or went non-finite: {tt_launches}")
        ckpts[task] = (base_t, os.path.join(tt.run_dir, "nn", "latest.pt"))
    base_ih, ckpt_ih = ckpts["InHandReorientation"]
    iev, iev_launches, iev_s = train_run(base_ih + [
        "test=true", f"checkpoint={ckpt_ih}", f"testGamesNum={N_ENVS}", "env.episodeLength=4"],
        False)
    log(f"[train] InHandReorientation eval from {os.path.relpath(ckpt_ih, ROOT)}: "
        f"{iev.stats[-1]} in {iev_s:.2f} s; launches {iev_launches}")
    check(iev_launches["control_step"] > 0 and iev.stats[-1]["episodes"] >= N_ENVS,
          f"InHandReorientation evaluation missed K2: {iev_launches}")

    # ---------------------------------------------------------------- user surface
    surface = surface_phases(dev, N_ENVS, gen, train_run, tr, ckpt, horizon)

    # ---------------------------------------------------------------- graphics
    graphics = graphics_phase(dev, N_ENVS, gen, cli, train_run, ckpt, card)

    # ---------------------------------------------------------------- tools
    tools = tools_phase(dev, N_ENVS, card)

    # ---------------------------------------------------------------- dist
    dist_launches = dist_phase(N_ENVS)

    # ---------------------------------------------------------------- 9 numbers
    # kernel timings on the phase-3/4/5 inputs (launches here are not counted).
    # K1 writes its state rows in place, so each timed call first restores
    # them: two device copies of 2.7 MB, a few microseconds of its time.
    saved = dict(kb.LAUNCHES)
    rf, ri = fs_k1.rows_f.clone(), fs_k1.rows_i.clone()

    def k1_on_phase4_inputs(fn):
        rf.copy_(fs_k1.rows_f)
        ri.copy_(fs_k1.rows_i)
        return fn(rf, ri, act_T, rst, drn, spw)

    k1_ms = kb.device_ms(lambda: k1_on_phase4_inputs(fused.kernel), 20)
    k1_paced_ms = cuda_ms(lambda: k1_on_phase4_inputs(fused.kernel), 20)
    # K1 at the README recipe's width (numEnvs=8192): the phase-4 columns twice
    k1_8192_ms = device_ms_twice(fused.kernel, fs_k1, (act_T, rst, drn, spw))
    log(f"[numbers] K1 at {N_ENVS} envs {k1_ms:.4f} ms/launch, at {2 * N_ENVS} envs (the "
        f"README recipe's numEnvs) {k1_8192_ms:.4f} ms/launch, device time ({card})")
    k1_plain_ms = cuda_ms(lambda: k1_on_phase4_inputs(fused.kernel_plain), 1, 1)
    T = lambda x: x.t().contiguous()
    rows = (T(ph.q), T(ph.qd), T(tgt), T(spawn), T(box(ph)), dr.rows().contiguous())
    k2 = lambda: lane_step.control_step_rows(c.engine, c.physics_steps_per_control, *rows)
    k2_ms, k2_paced_ms = kb.device_ms(k2, 20), cuda_ms(k2, 20)
    k2_plain_ms = cuda_ms(lambda: plain_cs(ph, tgt, spawn, dr), 1, 1)
    msz = lambda: lane_step.min_site_z(c.engine, ph.q, env._spawn, tips)
    msz_ms, msz_paced_ms = kb.device_ms(msz, 50), cuda_ms(msz, 50)
    msz_plain_ms = cuda_ms(lambda: c.engine.min_site_z(ph.q, spawn, tips), 5)
    # K3 warm: the phase-5 systems back to back, in L2 as the Coriolis step
    # leaves them; cold: rotating over copies whose lower triangles' sectors
    # (2,016 bytes a system) hold twice the 50 MB L2
    k3_ms = kb.device_ms(lambda: linalg.spd_solve(A3, b3), 200)
    k3_paced_ms = cuda_ms(lambda: linalg.spd_solve(A3, b3), 50)
    copies = [(A3.clone(), b3.clone()) for _ in range(12)]
    turn = [0]

    def k3_cold():
        A_, b_ = copies[turn[0] % len(copies)]
        turn[0] += 1
        return linalg.spd_solve(A_, b_)

    k3_cold_ms = kb.device_ms(k3_cold, 10 * len(copies))
    del copies
    k3_plain_ms = cuda_ms(lambda: linalg.spd_solve_plain(A3, b3), 20)
    k3_lib_ms = cuda_ms(lambda: torch.linalg.solve(A3, b3[..., None]), 20)
    log(f"[numbers] spd_solve library yardsticks: torch.linalg.solve {k3_lib_ms:.4f} ms, "
        f"cholesky + cholesky_solve (the plain version) {k3_plain_ms:.4f} ms")
    # K1's task builds on their phase inputs, K2's
    # two-box build on phase [box2]'s
    k1_task = {}
    for label, (env_t, fused_t, err, (fs_t, ins_t), ko_t, done_t) in k1_runs.items():
        rf_t, ri_t = fs_t.rows_f.clone(), fs_t.rows_i.clone()

        def on_inputs(fn, fs_t=fs_t, rf_t=rf_t, ri_t=ri_t, ins_t=ins_t):
            rf_t.copy_(fs_t.rows_f)
            ri_t.copy_(fs_t.rows_i)
            return fn(rf_t, ri_t, *ins_t)

        k1_task[label] = dict(
            ms=kb.device_ms(lambda: on_inputs(fused_t.kernel), 20),
            paced=cuda_ms(lambda: on_inputs(fused_t.kernel), 20),
            plain=cuda_ms(lambda: on_inputs(fused_t.kernel_plain), 1, 1),
            bytes=nbytes(rf_t, ri_t, *ins_t, *ko_t, rf_t, ri_t))
    rows2 = (T(ph_st.q), T(ph_st.qd), T(tgt_st), T(spawn), T(boxes(ph_st)),
             dr_st.rows().contiguous())
    # K1's BoxStacking build at 8192 envs: its phase inputs twice
    k1_st_8192_ms = device_ms_twice(fused_st.kernel, *k1_runs["stacking"][3])
    log(f"[numbers] K1 fused_step_stacking at {N_ENVS} envs {k1_task['stacking']['ms']:.4f} "
        f"ms/launch, at {2 * N_ENVS} envs {k1_st_8192_ms:.4f} ms/launch, device time ({card})")
    k2b_fn = lambda: lane_step.control_step_rows(c_st.engine, steps_st, *rows2)
    k2b_ms, k2b_paced_ms = kb.device_ms(k2b_fn, 20), cuda_ms(k2b_fn, 20)
    k2b_plain_ms = cuda_ms(lambda: plain_st(ph_st, tgt_st, spawn, dr_st), 1, 1)

    # where a rollout step's time goes: torch.profiler over 20 fused steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs = fused.pack(env.state)
        for _ in range(20):
            acts = torch.rand(N_ENVS, env.num_actions, generator=gen, device=dev) * 2 - 1
            fs, obs, rew, done, _ = fused.step_fn(fs, acts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0}
    busy = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
    log(f"[profile] 20 fused steps x {N_ENVS} envs: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top: "
        + "; ".join(f"{k[:48]} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f}%)" for k, v in top))

    kb.LAUNCHES.update(saved)
    # f32 operations counted from the kernel code for this run's inputs: K1's
    # spawn projection runs only for the n_done envs that reset in phase 4
    cs_lib, fs_lib = kb.load("control_step"), kb.load("fused_step")
    r = lane_step.lane_model_array(c.engine, c.physics_steps_per_control, cs_lib)
    r_cfg = fused_step.fused_config_array(env, fused.layout, fused.comp_names,
                                          fused.rst_rows, fs_lib)
    f_k1 = fused_step.fused_step_flops(r_cfg, r, N_ENVS, n_done)
    f_k2 = lane_step.control_step_flops(r) * N_ENVS
    f_msz = lane_step.min_site_z_flops(r, len(tips)) * N_ENVS
    b_k1 = nbytes(rf, ri, act_T, rst, drn, spw, *ko, rf, ri)
    b_k2 = 4 * N_ENVS * (26 * 3 + 3 + 13 + 4 + 26 * 2 + 13 + 78 + 3 + 26 * 19 + 10 * 7)
    b_msz = 4 * N_ENVS * (26 + 3 + 1)
    b_k3 = linalg.spd_solve_bytes(26) * N_ENVS
    f_k3 = linalg.spd_solve_flops(26) * N_ENVS
    r2 = lane_step.lane_model_array(c_st.engine, steps_st, kb.load("control_step_box2"))
    f_k2b = lane_step.control_step_flops(r2) * N_ENVS
    b_k2b = nbytes(*rows2, *lane_step.control_step_rows(c_st.engine, steps_st, *rows2))
    for label, (env_t, fused_t, _, _, _, done_t) in k1_runs.items():
        r_t = lane_step.lane_model_array(env_t.comps.engine, env_t.comps.physics_steps_per_control,
                                         kb.load(fused_t.build))
        cfg_t = fused_step.fused_config_array(env_t, fused_t.layout, fused_t.comp_names,
                                              fused_t.rst_rows, kb.load(fused_t.build))
        k1_task[label]["flops"] = fused_step.fused_step_flops(cfg_t, r_t, N_ENVS, done_t,
                                                              fused_t.build)
    launches["spd_solve"] = co_launches["spd_solve"]
    launches["clip_adam"] = adam["launches"] + tr_launches["clip_adam"]
    for name, count in graphics.items():  # [graphics]'s evaluation runs
        launches[name] += count
    for name, count in tools.items():  # [tools]'s runs
        launches[name] += count
    k3_bound = bound(b_k3, f_k3)[0]
    log(f"[numbers] spd_solve at {N_ENVS} systems: warm {k3_ms:.5f} ms/launch (queued; paced by "
        f"the host's launches {k3_paced_ms:.5f}), cold {k3_cold_ms:.5f} ms/launch = "
        f"{k3_cold_ms / k3_bound:.2f}x its byte bound of {k3_bound:.5f} ms ({card})")
    kernels = []
    ms_8192 = {"fused_step": k1_8192_ms, "fused_step_stacking": k1_st_8192_ms}
    timing = ("ms: device time of launches queued behind a sleeping kernel "
              "(kernel_build.device_ms); ms_8192: the same at 8192 envs (the phase inputs "
              "twice); paced_ms, plain_ms, library_ms: CUDA events around calls paced by the "
              "host")
    for name, src, rep, ms, paced, pms, err, (bms, by), lib_ms in (
        ("fused_step", "dexrobot_isaac_tpu_torch/csrc/fused_step.cu",
         "dexrobot_isaac_tpu/envs/fused_step.py:1080", k1_ms, k1_paced_ms, k1_plain_ms,
         k1["obs"], bound(b_k1, f_k1), None),
        ("control_step", "dexrobot_isaac_tpu_torch/csrc/control_step.cu",
         "dexrobot_isaac_tpu/physics/pallas_step.py:1141", k2_ms, k2_paced_ms, k2_plain_ms,
         k2_abs, bound(b_k2, f_k2), None),
        ("min_site_z", "dexrobot_isaac_tpu_torch/csrc/control_step.cu",
         "dexrobot_isaac_tpu/physics/pallas_step.py:986", msz_ms, msz_paced_ms, msz_plain_ms,
         mz_err, bound(b_msz, f_msz), None),
        ("spd_solve", "dexrobot_isaac_tpu_torch/csrc/spd_solve.cu",
         "dexrobot_isaac_tpu/ops/linalg.py:113", k3_ms, k3_paced_ms, k3_plain_ms, k3_abs,
         bound(b_k3, f_k3), k3_lib_ms),
        *((k1_runs[label][1].build, "dexrobot_isaac_tpu_torch/csrc/fused_step.cu",
           "dexrobot_isaac_tpu/envs/fused_step.py:1080", k1_task[label]["ms"],
           k1_task[label]["paced"], k1_task[label]["plain"], k1_runs[label][2]["obs"],
           bound(k1_task[label]["bytes"], k1_task[label]["flops"]), None)
          for label in k1_runs),
        ("control_step_box2", "dexrobot_isaac_tpu_torch/csrc/control_step.cu",
         "dexrobot_isaac_tpu/physics/pallas_step.py:1141", k2b_ms, k2b_paced_ms, k2b_plain_ms,
         k2b_abs, bound(b_k2b, f_k2b), None),
        ("clip_adam", "dexrobot_isaac_tpu_torch/csrc/clip_adam.cu",
         "none (the JAX learner's optax chain, left to XLA)", adam["ms"], adam["paced"],
         adam["plain"], adam["err"], adam["bound"], None),
    ):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[name], "max_abs_err": err, "ms": ms,
                        "paced_ms": paced, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms, "timing": timing,
                        **({"launches_dist": dist_launches} if name == "fused_step" else {}),
                        **({"ms_8192": ms_8192[name]} if name in ms_8192 else {}),
                        **({"launches_graphics": graphics[name]} if name in graphics else {}),
                        **({"launches_tools": tools[name]} if name in tools else {})})
        log(f"[numbers] {name}: {ms:.5f} ms/launch (paced by the host {paced:.5f}), plain "
            f"{pms:.4f} ms, bound {bms:.5f} ms ({by}), library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, launches {launches[name]}")
    log(f"[numbers] env-steps/s {sps:,.0f} (" + ", ".join(
        f"{k} {v:,.0f}" for k, v in path_sps.items()) + f"), training env-steps/s "
        f"{train_sps:,.0f} ({card}); total {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def clip_adam_main() -> int:
    """The [clip_adam] phase alone, after building its kernel alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dexrobot_isaac_tpu_torch.utils import kernel_build

    global kb
    kb = kernel_build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = kb.card()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[build] nvcc seconds: {kb.build_all(['clip_adam'])}")
    with open(kb.lib_path("clip_adam") + ".ptxas.txt") as f:
        for line in kb.ptxas_lines(f.read()):
            log(f"[build] clip_adam: {line}")
    print(json.dumps(clip_adam_phase(torch.device("cuda"), card)))
    print(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["--clip-adam"]:
        sys.exit(clip_adam_main())
    sys.exit(main())

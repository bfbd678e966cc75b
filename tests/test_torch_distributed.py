"""The port's multi-process training (`parallel/`) held against the JAX
package's `shard_map` learner, on the CPU over gloo.

- one minibatch update on 4 ranks, each with its quarter of the minibatch,
  against the JAX `PPOLearner(axis_name=DATA_AXIS)` under `shard_map` on 4
  of the conftest's 8 virtual CPU devices: the reduced gradients (atol
  1e-5), the new params (`test_update_params_match_jax`'s tolerance) and
  the KL (1e-5 relative); with the KL gate, every rank skips where the
  global KL is past it, and none where only one rank's own KL is;
- the batch moments (global count) and the advantage normalization on 4
  ranks against JAX under `shard_map` (atol 1e-6);
- the consecutive-successes counter counts a success on any rank (JAX's
  `pmax`), on the unfused and the plain fused step; the unfused step's
  termination rates and criterion means are averaged over the ranks
  (JAX's `pmean`);
- world size 1 against no group, bit for bit (2 iterations of the plain
  fused step);
- 2 ranks x 4 envs through the CLI's training: params equal after each
  iteration, per-rank reset and DR draws (rank 0's a single process's),
  the curriculum promoting alike from the breakdown summed over the ranks;
- the CLI launched as 2 processes with torchrun's environment: rank 0
  alone writes, and rank 1 makes no directory of its own, also when it
  fails; `test=true` and an uneven `numEnvs` are refused;
- `dryrun_multichip(4)`.

Ranks are processes of `spawn_ranks` (gloo on a free local port, each
spawn cut at 120 s); their functions are in tests/torch_dist_workers.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dexrobot_isaac_tpu.parallel.mesh import DATA_AXIS, make_mesh
from dexrobot_isaac_tpu.rl.ppo import PPOConfig as JaxConfig
from dexrobot_isaac_tpu.rl.ppo import PPOLearner as JaxLearner
from dexrobot_isaac_tpu.rl.ppo import _policy_kl as jax_policy_kl
from dexrobot_isaac_tpu.rl.running_stats import RunningMeanStd as JaxRMS
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.parallel.distributed import dryrun_multichip, spawn_ranks
from dexrobot_isaac_tpu_torch.parallel.mesh import free_port, init_distributed
from dexrobot_isaac_tpu_torch.rl.ppo import PPOLearner, ppo_config_from
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_dist_workers as workers
from tests.proc import start, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
RANKS, NUM_OBS, NUM_ACT, NUM_ENVS = 4, 6, 3, 32
SMALL = dict(num_actions=NUM_ACT, num_obs=NUM_OBS, num_envs=NUM_ENVS, horizon_length=4,
             units=(32, 16))
LR = 1e-3
# the KL gates: rank 0's quarter of the "gated" minibatch drifts far (mu_old
# shifted by 5), the others' barely; "skip" sits between the others' KL and
# the global one, "keep" between the global KL and rank 0's
GATES = {"skip": 125.0, "keep": 2500.0}
SPAWN_TIMEOUT = 120


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_capture():
    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), {"g": updates}

    return optax.GradientTransformation(init, update)


def _port(tree):
    return convert.actor_critic_from_flax(_np(tree), "cpu")


# ---------------------------------------------------------------- 4 ranks vs shard_map
@pytest.fixture(scope="module")
def update_case(tmp_path_factory):
    rng = np.random.default_rng(11)
    mesh = make_mesh(jax.devices()[:RANKS])
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jl = JaxLearner(JaxConfig(**SMALL), None, seed=0, axis_name=DATA_AXIS)
    jst = jl.init_state(jax.random.key(0))
    jrms = JaxRMS(mean=f(NUM_OBS), var=rng.uniform(0.5, 2, NUM_OBS).astype(np.float32),
                  count=np.float32(64))
    vrms = JaxRMS.create(())
    obs = f(NUM_ENVS, NUM_OBS)
    mu, log_std, value = (np.asarray(v) for v in jl._forward(jst.params, jrms, obs))
    sigma = np.exp(log_std)
    action = (mu + sigma * f(*mu.shape)).astype(np.float32)
    logp = (-0.5 * ((action - mu) ** 2 / sigma ** 2 + 2 * log_std
                    + np.log(2 * np.pi))).sum(-1).astype(np.float32)
    mb = [obs, action, logp + 0.3 * f(NUM_ENVS), value + 0.3 * f(NUM_ENVS), f(NUM_ENVS),
          f(NUM_ENVS), (mu + 0.1 * f(*mu.shape)).astype(np.float32),
          np.exp(log_std + 0.1 * f(*mu.shape)).astype(np.float32)]
    gated = list(mb)
    gated[6] = gated[6].copy()
    gated[6][:NUM_ENVS // RANKS] += 5.0
    quarters = np.split(np.arange(NUM_ENVS), RANKS)
    local_kl = [float(jax_policy_kl(mu[q], sigma[q], gated[6][q], gated[7][q])) for q in quarters]
    cases = {"update": ({}, mb), "skip": (dict(kl_skip_factor=GATES["skip"]), gated),
             "keep": (dict(kl_skip_factor=GATES["keep"]), gated)}

    def jax_update(kw, data, capture):
        jlc = JaxLearner(JaxConfig(**SMALL, **kw), None, seed=0, axis_name=DATA_AXIS)
        st = jlc.init_state(jax.random.key(0))
        opt = st.opt_state
        if capture:  # an optimizer that keeps the (pmean'd) gradient in its state
            jlc._tx = optax.inject_hyperparams(lambda learning_rate: _grad_capture())(
                learning_rate=jnp.float32(LR))
            opt = jlc._tx.init(st.params)

        def body(params, opt, data):
            (p, o, _, _, _, _), kl = jlc._update_minibatch(
                (params, opt, jnp.float32(LR), jrms, vrms, jnp.float32(0)), data)
            return p, o, kl

        run = shard_map(body, mesh=mesh, in_specs=(P(), P(), P(DATA_AXIS)),
                        out_specs=(P(), P(), P()), check_vma=False)
        return jax.jit(run)(jst.params, opt, tuple(data))

    want = {}
    for case, (kw, data) in cases.items():
        params, opt, kl = jax_update(kw, data, capture=False)
        # the gradient does not depend on the gate, which would keep the
        # capturing optimizer's old state where it skips
        _, gopt, _ = jax_update({}, data, capture=True)
        want[case] = dict(params=_port(params), grads=_port(gopt.inner_state["g"]),
                          kl=float(kl), count=int(opt.inner_state[1][0].count))

    # the batch moments of (T, N, W) rollout observations and the
    # advantage normalization, each rank holding its envs
    batch, adv = f(4, NUM_ENVS, NUM_OBS) * 3 + 1, f(4, NUM_ENVS) * 2 - 0.5

    def moments(b):
        return jl._batch_moments(b.reshape(-1, b.shape[-1]))

    def normalize(a):  # the JAX learner's advantage normalization (:472-475)
        mean = jl._pmean(a.mean())
        var = jl._pmean(((a - mean) ** 2).mean())
        return (a - mean) / (jnp.sqrt(var) + 1e-8)

    sm = lambda fn, out: jax.jit(shard_map(fn, mesh=mesh, in_specs=P(None, DATA_AXIS),
                                           out_specs=out, check_vma=False))
    want["moments"] = [np.asarray(x) for x in sm(moments, (P(), P(), P()))(batch)]
    want["adv"] = np.asarray(sm(normalize, P(None, DATA_AXIS))(adv))

    path = str(tmp_path_factory.mktemp("update"))
    torch.save({"n": NUM_ENVS, "small": SMALL, "lr": LR, "params": _port(jst.params),
                "obs_rms": {k: T(np.asarray(v)) for k, v in vars(jrms).items()},
                "cases": {k: (kw, [T(x) for x in d]) for k, (kw, d) in cases.items()},
                "batch": T(batch), "adv": T(adv)}, os.path.join(path, "in.pt"))
    spawn_ranks(workers.update_worker, RANKS, (path,), SPAWN_TIMEOUT)
    got = [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False)
           for r in range(RANKS)]
    return dict(want=want, got=got, local_kl=local_kl, params0=_port(jst.params))


@pytest.mark.parametrize("case", ["update", "skip", "keep"])
def test_update_gradients_match_shard_map(update_case, case):
    want = update_case["want"][case]
    for got in update_case["got"]:
        for k, g in got[case]["grads"].items():
            torch.testing.assert_close(g, want["grads"][k], rtol=0, atol=1e-5, msg=k)
        assert float(got[case]["kl"]) == pytest.approx(want["kl"], rel=1e-5)


@pytest.mark.parametrize("case", ["update", "skip", "keep"])
def test_update_params_match_shard_map(update_case, case):
    want = update_case["want"][case]
    ranks = update_case["got"]
    for got in ranks:
        assert float(got[case]["kl_step"]) == pytest.approx(want["kl"], rel=1e-5)
        assert int(got[case]["count"]) == want["count"]
        for k, p in got[case]["params"].items():
            live = want["grads"][k].abs() > 1e-6
            assert bool(live.any())
            torch.testing.assert_close(p[live], want["params"][k][live], rtol=0, atol=1e-6)
            torch.testing.assert_close(p, want["params"][k], rtol=0, atol=2e-3 + 1e-6)
            assert torch.equal(p, ranks[0][case]["params"][k]), "the ranks' params differ"


def test_kl_gate_decides_on_the_global_kl(update_case):
    """`skip`: only rank 0's own KL is past the gate, the global one too, so
    every rank skips; `keep`: rank 0's own KL is past it, the global one is
    not, so none does. A rank deciding on its own KL would split."""
    local, want = update_case["local_kl"], update_case["want"]
    gate = lambda case: GATES[case] * 0.008
    assert max(local[1:]) < gate("skip") < want["skip"]["kl"] < local[0]
    assert want["keep"]["kl"] < gate("keep") < local[0]
    assert want["skip"]["count"] == 0 and want["keep"]["count"] == 1
    for got in update_case["got"]:
        assert int(got["skip"]["count"]) == 0
        assert all(torch.equal(p, update_case["params0"][k])
                   for k, p in got["skip"]["params"].items())
        assert int(got["keep"]["count"]) == 1


def test_batch_moments_match_shard_map(update_case):
    want = update_case["want"]["moments"]
    for got in update_case["got"]:
        mean, var, count = got["moments"]
        np.testing.assert_allclose(mean.numpy(), want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), want[1], rtol=0, atol=1e-6)
        assert float(count) == float(want[2]) == 4 * NUM_ENVS


def test_advantage_normalization_matches_shard_map(update_case):
    want = np.split(update_case["want"]["adv"], RANKS, axis=1)
    for r, got in enumerate(update_case["got"]):
        np.testing.assert_allclose(got["adv"].numpy(), want[r], rtol=0, atol=1e-6)


# ---------------------------------------------------------------- 2 ranks through the CLI
TRAIN_ARGV = [
    "task=BlindGrasping", "experiments=BlindGraspingDR", "numEnvs=8", "device=cpu",
    "env.episodeLength=4", "sim.substeps=1", "sim.physics_steps_per_control=1",
    "maxIterations=2", "train.logging.noLogFile=true", "train.params.config.fused=on",
    "train.params.config.dispatch_chunk=1", "train.params.network.units=[32,32]",
    "train.params.config.horizon_length=4", "train.params.config.minibatch_size=8",
    "train.params.config.mini_epochs=1", "train.params.config.log_interval=1",
    "train.params.config.save_frequency=2",
    # each rank's 4 envs end 4 episodes an iteration (3-step episodes): the
    # curriculum promotes when it counts the 8 of both ranks
    "task.curriculum.min_episodes=6", "task.curriculum.promote_success_rate=0.0",
]
SMALL_ENV = ["task=BlindGrasping", "numEnvs=4", "env.episodeLength=50", "sim.substeps=1",
             "sim.physics_steps_per_control=1"]
# pattern[t][r]: a success on rank r at step t
PATTERN = [(0, 1), (0, 0), (1, 0), (1, 1), (0, 1)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rng = np.random.default_rng(12)
    kinds = [rng.integers(0, 5, (3, 4)) for _ in range(2)]
    window = [{"success": T(k == 0), "failure": T(k == 1), "timeout": T(k == 2),
               "reward_components_packed": T(rng.normal(size=(3, 4, 2)).astype(np.float32))}
              for k in kinds]
    path = str(tmp_path_factory.mktemp("train"))
    torch.save({"argv": TRAIN_ARGV, "window": window, "small_env": SMALL_ENV,
                "pattern": PATTERN}, os.path.join(path, "in.pt"))
    spawn_ranks(workers.train_worker, 2, (path,), SPAWN_TIMEOUT)
    got = [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return dict(path=path, got=got, window=window)


def test_two_ranks_keep_equal_params(two_ranks):
    r0, r1 = two_ranks["got"]
    assert r0["rc"] == r1["rc"] == 0 and r0["num_envs"] == r1["num_envs"] == 4
    assert len(r0["params"]) == len(r1["params"]) == 2
    for p0, p1 in zip(r0["params"], r1["params"]):
        assert workers.same_state(p0, p1)
    assert not workers.same_state(r0["params"][0], r0["params"][1])  # it trained


def test_two_ranks_draw_apart_and_rank0_as_one_process(two_ranks):
    (reset0, dr0), (reset1, dr1) = (g["draws"][0] for g in two_ranks["got"])
    assert not torch.equal(reset0.dof_pos, reset1.dof_pos)
    assert not torch.equal(reset0.box_pos, reset1.box_pos)
    assert not torch.equal(dr0.kp_scale, dr1.kp_scale)
    # one process with rank 0's 4 envs draws the same
    env = make_env(load_config(TRAIN_ARGV + ["numEnvs=4"]), seed=42, device="cpu")
    reset, dr = env.draw_samples(4, torch.tensor(env.comps.initial_difficulty))
    assert workers.same_state(reset, reset0) and workers.same_state(dr, dr0)


def test_two_ranks_promote_alike(two_ranks):
    r0, r1 = two_ranks["got"]
    assert r0["state"] == r1["state"]
    assert [s["difficulty"] for s in r0["stats"]] == [s["difficulty"] for s in r1["stats"]]
    assert r0["stats"][0]["difficulty"] > 0.0  # promoted after the first window
    assert [s["reward_mean"] for s in r0["stats"]] == [s["reward_mean"] for s in r1["stats"]]


def test_breakdown_window_sums_the_ranks(two_ranks):
    from dexrobot_isaac_tpu_torch.rl.observer import DeviceBreakdown

    local = []
    for ex in two_ranks["window"]:
        bd = DeviceBreakdown.create(ex, comp_names=("a", "b"))
        bd.update(ex)
        local.append(bd.fetch_and_reset())
    for got in (g["window"] for g in two_ranks["got"]):
        for k in ("ep_count", "step_sum", "ep_count_strict"):
            np.testing.assert_allclose(got[k], local[0][k] + local[1][k], rtol=1e-6)
        for c in ("a", "b"):
            np.testing.assert_allclose(got["comp_sum"][c],
                                       local[0]["comp_sum"][c] + local[1]["comp_sum"][c],
                                       rtol=1e-6)


@pytest.mark.parametrize("step", ["unfused", "fused"])
def test_consecutive_successes_count_any_rank(two_ranks, step):
    """JAX: pmax of each shard's any-success, then +1 (capped) or reset."""
    mesh = make_mesh(jax.devices()[:2])
    flags = np.asarray(PATTERN, np.int32)                 # (T, ranks)
    anywhere = shard_map(lambda f: jax.lax.pmax(f.any(-1).astype(jnp.int32), DATA_AXIS),
                         mesh=mesh, in_specs=P(None, DATA_AXIS), out_specs=P(),
                         check_vma=False)(flags)
    want, c = [], 0
    for a in np.asarray(anywhere):
        c = min(c + 1, 50) if a > 0 else 0
        want.append(c)
    assert want == [1, 0, 1, 2, 3]
    for got in two_ranks["got"]:
        assert got["consecutive"][step] == want


def test_scalar_extras_agree_across_ranks(two_ranks):
    """The unfused step's scalar extras are global: the float ones (the
    termination rates and criterion means) averaged over the ranks, as JAX
    pmeans them; the consecutive counter by its max."""
    r0, r1 = (g["consecutive"]["scalars"] for g in two_ranks["got"])
    assert r0 == r1
    for s, (p0, p1) in zip(r0, PATTERN):
        assert {"consecutive_successes", "success_rate", "failure_rate", "timeout_rate",
                "success_grasp_lift_success", "failure_hitting_ground"} <= set(s)
        # the pattern's success in env 0 of 2 per rank
        assert s["success_rate"] == (p0 + p1) / 4


def test_two_ranks_only_rank0_writes(two_ranks):
    path = two_ranks["path"]
    runs = os.listdir(os.path.join(path, "runs0", "runs_all"))
    assert len(runs) == 1
    assert "latest.pt" in os.listdir(os.path.join(path, "runs0", "runs_all", runs[0], "nn"))
    assert os.listdir(os.path.join(path, "runs1")) == []
    assert not os.path.exists(two_ranks["got"][1]["run_dir"])


# ---------------------------------------------------------------- world size 1
def test_world_size_one_is_bitwise_no_group(monkeypatch):
    argv = ["task=BlindGrasping", "numEnvs=8", "device=cpu", "env.episodeLength=5",
            "sim.substeps=1", "sim.physics_steps_per_control=2",
            "train.params.network.units=[32,32]", "train.params.config.horizon_length=4",
            "train.params.config.mini_epochs=2"]
    cfg = load_config(argv)

    def train(group):
        env = make_env(cfg, seed=3, device="cpu", group=group)
        fused = env.make_fused()
        learner = PPOLearner(ppo_config_from(cfg, env), fused.step_fn, seed=3, device="cpu",
                             group=group)
        ppo = learner.broadcast_state(learner.init_state())
        fs, obs = fused.reset()
        for _ in range(2):
            ppo, fs, obs, metrics, _ = learner.train_iteration(ppo, fs, obs)
        return ppo, fs, obs, metrics

    alone = train(None)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.setenv(k, "1" if k == "WORLD_SIZE" else "0")
    group = init_distributed("cpu")
    try:
        assert group.active and group.world_size == 1
        grouped = train(group)
    finally:
        group.close()
    for a, b in zip(alone, grouped):
        assert workers.same_state(a, b)


def test_rank_generators_and_resume(tmp_path):
    """Rank 0 draws what a single process draws, rank 1 apart; a checkpoint
    (rank 0's generator) resumes rank 0's draws and keeps rank 1's apart."""
    from dexrobot_isaac_tpu_torch.parallel.mesh import Group
    from dexrobot_isaac_tpu_torch.rl.checkpoint import load_checkpoint, save_checkpoint
    from dexrobot_isaac_tpu_torch.rl.ppo import PPOConfig

    cfg, cpu = PPOConfig(**SMALL), torch.device("cpu")
    ranks = [PPOLearner(cfg, None, seed=3, device="cpu", group=Group(r, 2, cpu)) for r in (0, 1)]
    first = [lr._randn((5,)) for lr in ranks]
    assert torch.equal(first[0], PPOLearner(cfg, None, seed=3, device="cpu")._randn((5,)))
    assert not torch.equal(first[0], first[1])
    state = ranks[0].init_state()
    state.epoch += 7
    path = str(tmp_path / "nn" / "latest.pt")
    save_checkpoint(path, state, {}, ranks[0])
    want = ranks[0]._randn((5,))
    for lr in ranks:
        assert int(load_checkpoint(path, lr.init_state(), lr).epoch) == 7
    resumed = [lr._randn((5,)) for lr in ranks]
    assert torch.equal(resumed[0], want) and not torch.equal(resumed[0], resumed[1])


# ---------------------------------------------------------------- the CLI, 2 processes
CLI_ARGS = [
    "device=cpu", "task=BaseTask", "numEnvs=16", "maxIterations=2", "env.episodeLength=8",
    "sim.substeps=1", "sim.physics_steps_per_control=2", "train.logging.noLogFile=true",
    "train.params.config.save_frequency=2", "train.params.network.units=[32,32]",
    "train.params.config.horizon_length=4", "train.params.config.minibatch_size=8",
    "train.params.config.mini_epochs=1",
]


def _launch(args, world, rank, port, runs):
    """The CLI as one rank, its runs and its temporary files under `runs`
    and `runs`_tmp."""
    tmp = runs.parent / f"{runs.name}_tmp"
    tmp.mkdir()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               DEXHAND_RUNS_DIR=str(runs), PYTHONPATH=REPO, TMPDIR=str(tmp))
    return start([sys.executable, "-m", "dexrobot_isaac_tpu_torch.train", *args], cwd=REPO,
                 env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    runs = {k: base / k for k in ("train0", "train1", "test", "odd0", "odd1")}
    for d in runs.values():
        d.mkdir()
    p_train, p_odd = free_port(), free_port()
    procs = {
        "train0": _launch(CLI_ARGS, 2, 0, p_train, runs["train0"]),
        "train1": _launch(CLI_ARGS, 2, 1, p_train, runs["train1"]),
        "test": _launch(CLI_ARGS + ["test=true"], 2, 0, free_port(), runs["test"]),
        "odd0": _launch(CLI_ARGS + ["numEnvs=15"], 2, 0, p_odd, runs["odd0"]),
        "odd1": _launch(CLI_ARGS + ["numEnvs=15"], 2, 1, p_odd, runs["odd1"]),
    }
    outs = wait_all(list(procs.values()), SPAWN_TIMEOUT)
    return runs, {k: (o, p.returncode) for (k, p), (o, _) in zip(procs.items(), outs)}


def test_cli_two_processes_rank0_writes(cli_runs):
    runs, out = cli_runs
    assert out["train0"][1] == 0 and out["train1"][1] == 0, out["train0"][0] + out["train1"][0]
    run = sorted(os.listdir(runs["train0"] / "runs_all"))[-1]
    assert "latest.pt" in os.listdir(runs["train0"] / "runs_all" / run / "nn")
    assert os.listdir(runs["train1"]) == []
    assert "rank 1 of 2 (gloo, cpu)" in out["train1"][0]
    # rank 1 names a run dir in its TMPDIR but makes none
    assert "Run directory: " + str(runs["train1"]) + "_tmp/dexhand_rank1" in out["train1"][0]
    assert os.listdir(str(runs["train1"]) + "_tmp") == []


def test_cli_refuses_multiprocess_eval(cli_runs):
    runs, out = cli_runs
    text, rc = out["test"]
    assert rc != 0 and "test=true is single-process" in text
    assert os.listdir(runs["test"]) == []


def test_cli_refuses_uneven_shards(cli_runs):
    runs, out = cli_runs
    for k in ("odd0", "odd1"):
        text, rc = out[k]
        assert rc != 0 and "numEnvs=15 does not divide over 2 ranks" in text
    assert os.listdir(str(runs["odd1"]) + "_tmp") == []


# ---------------------------------------------------------------- dryrun
def test_dryrun_multichip_four_ranks(capfd):
    dryrun_multichip(4, timeout=SPAWN_TIMEOUT)
    lines = [ln for ln in capfd.readouterr().out.splitlines() if "dryrun_multichip" in ln]
    assert len(lines) == 1 and "dryrun_multichip(4): OK" in lines[0]
    assert "envs=16 sharded over 4 ranks" in lines[0]

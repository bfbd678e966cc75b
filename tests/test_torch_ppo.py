"""The port's PPO pieces held against the JAX package's (CPU, tiny nets).

- flax `ActorCritic` params carried over by `convert.actor_critic_from_flax`
  give the port's network the same mu, log_std and value (1e-5), for the
  shared and the asymmetric net (and in bf16 at bf16's precision);
- `RunningMeanStd`, GAE (1e-5), `_adapt_lr`, the `affine` multiplier table
  and the `rotation` static permutation equal the JAX learner's;
- one `_update_minibatch` on the same batch: gradients within 1e-4 of their
  max, then the Adam-updated params where |g| > 1e-6 (Adam's first step is
  +-lr sign(g), so a vanishing gradient's sign decides its param);
- the clip + Adam update against optax's chain, the KL skip gate, the
  device breakdown reducer, checkpoints, the injected action noise, and
  learning on a toy problem as `tests/test_ppo.py` does.
"""

import math
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.rl.networks import ActorCritic as JaxNet
from dexrobot_isaac_tpu.rl.observer import DeviceBreakdown as JaxBreakdown
from dexrobot_isaac_tpu.rl.observer import RewardComponentObserver as JaxObserver
from dexrobot_isaac_tpu.rl.ppo import PPOConfig as JaxConfig
from dexrobot_isaac_tpu.rl.ppo import PPOLearner as JaxLearner
from dexrobot_isaac_tpu.rl.running_stats import RunningMeanStd as JaxRMS
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.rl.checkpoint import (
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from dexrobot_isaac_tpu_torch.rl.networks import ActorCritic
from dexrobot_isaac_tpu_torch.rl.observer import DeviceBreakdown, RewardComponentObserver
from dexrobot_isaac_tpu_torch.rl.ppo import AdamState, PPOConfig, PPOLearner
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd

T = torch.as_tensor
NUM_OBS, NUM_ACT, NUM_ENVS = 6, 3, 32
SMALL = dict(num_actions=NUM_ACT, num_obs=NUM_OBS, num_envs=NUM_ENVS, horizon_length=4,
             units=(32, 16))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _learners(**kw):
    return (JaxLearner(JaxConfig(**SMALL, **kw), None, seed=0),
            PPOLearner(PPOConfig(**SMALL, **kw), None, seed=0, device="cpu"))


# ---------------------------------------------------------------- network
@pytest.mark.parametrize("num_states", [0, 5])
def test_network_matches_flax(num_states):
    rng = np.random.default_rng(0)
    net = JaxNet(num_actions=NUM_ACT, units=(32, 16), num_states=num_states)
    params = _np(net.init(jax.random.key(0), jnp.zeros((1, NUM_OBS + num_states))))
    params["params"]["log_std"] = np.array([-6.0, 0.3, 2.5], np.float32)  # both clamps
    x = rng.normal(size=(7, NUM_OBS + num_states)).astype(np.float32)
    want = [np.asarray(v) for v in net.apply(params, x)]
    port = ActorCritic(NUM_OBS, NUM_ACT, (32, 16), num_states)
    p = convert.actor_critic_from_flax(params, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in port.named_parameters()}
    got = torch.func.functional_call(port, p, (T(x),))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5)


def test_bfloat16_network_keeps_float32_params():
    rng = np.random.default_rng(1)
    net = JaxNet(num_actions=NUM_ACT, units=(32, 16), compute_dtype=jnp.bfloat16)
    params = _np(net.init(jax.random.key(1), jnp.zeros((1, NUM_OBS))))
    x = rng.normal(size=(64, NUM_OBS)).astype(np.float32)
    port = ActorCritic(NUM_OBS, NUM_ACT, (32, 16), compute_dtype=torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in port.parameters())
    got = torch.func.functional_call(port, convert.actor_critic_from_flax(params, "cpu"),
                                     (T(x),))
    for g, w in zip(got, net.apply(params, x)):
        assert g.dtype == torch.float32
        assert _rel(g.detach().numpy(), w) <= 3e-2  # bf16 keeps ~3 digits


def test_init_is_flax_lecun_normal():
    port = ActorCritic(512, NUM_ACT, (256,), generator=torch.Generator().manual_seed(0))
    w = port.layers["Dense_0"].weight.detach()
    std = math.sqrt(1 / 512)
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(float(m.bias.detach().abs().max()) == 0 for m in port.layers.values())
    assert float(port.log_std.detach().abs().max()) == 0


# ---------------------------------------------------------------- stats, GAE, LR
def test_running_mean_std_matches_jax():
    rng = np.random.default_rng(2)
    j, t = JaxRMS.create((4,)), RunningMeanStd.create((4,))
    for i in range(3):
        batch = rng.normal(i, 1 + i, size=(50, 4)).astype(np.float32)
        j, t = j.update(batch), t.update(T(batch))
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)),
                                       rtol=1e-5)
    x = rng.normal(0, 9, size=(10, 4)).astype(np.float32)
    np.testing.assert_allclose(t.normalize(T(x)).numpy(), np.asarray(j.normalize(x)), atol=1e-5)
    np.testing.assert_allclose(t.normalize(T(x), clip=math.inf).numpy(),
                               np.asarray(j.normalize(x, clip=np.inf)), atol=1e-5)
    np.testing.assert_allclose(t.denormalize(T(x)).numpy(), np.asarray(j.denormalize(x)),
                               rtol=1e-5)


def test_gae_matches_jax():
    rng = np.random.default_rng(3)
    jl, tl = _learners()
    h, n = 4, NUM_ENVS
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    value, reward, last = f(h, n), f(h, n), f(n)
    done = rng.random((h, n)) < 0.2
    rms = dict(mean=np.float32(0.7), var=np.float32(2.3), count=np.float32(40.0))
    traj = types.SimpleNamespace(value=value, reward=reward, done=done)
    ja, jr = jl._gae(types.SimpleNamespace(value_rms=JaxRMS(**rms)), traj, last)
    ttraj = types.SimpleNamespace(value=T(value), reward=T(reward), done=T(done))
    ta, tr = tl._gae(types.SimpleNamespace(value_rms=RunningMeanStd(
        **{k: T(v) for k, v in rms.items()})), ttraj, T(last))
    assert _rel(ta.numpy(), ja) <= 1e-5 and _rel(tr.numpy(), jr) <= 1e-5


@pytest.mark.parametrize("lr", [1e-6, 3e-4, 1e-2])
@pytest.mark.parametrize("kl", [0.0, 0.004, 0.01, 0.02, 1.0])
def test_adapt_lr_matches_jax(lr, kl):
    jl, tl = _learners()
    want = float(jl._adapt_lr(jnp.float32(lr), jnp.float32(kl)))
    assert float(tl._adapt_lr(torch.tensor(lr), torch.tensor(kl))) == pytest.approx(want, 1e-6)


@pytest.mark.parametrize("n", [8, 64, 4096])
def test_shuffle_tables_equal_jax(n):
    jl, tl = _learners()
    np.testing.assert_array_equal(tl._affine_mults(n), np.asarray(jl._affine_mults(n)))
    np.testing.assert_array_equal(tl._static_perm(n), jl._static_perm(n))


# ---------------------------------------------------------------- one update
def _grad_capture():
    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), {"g": updates}

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def one_update():
    rng = np.random.default_rng(4)
    jl, tl = _learners()
    jst = jl.init_state(jax.random.key(0))
    obs = rng.normal(size=(NUM_ENVS, NUM_OBS)).astype(np.float32)
    jrms = JaxRMS(mean=rng.normal(size=NUM_OBS).astype(np.float32),
                  var=rng.uniform(0.5, 2, NUM_OBS).astype(np.float32), count=np.float32(64))
    mu, log_std, value = (np.asarray(v) for v in jl._forward(jst.params, jrms, obs))
    action = (mu + np.exp(log_std) * rng.normal(size=mu.shape)).astype(np.float32)
    logp = np.asarray(jax.vmap(lambda m, s, a: -0.5 * jnp.sum(
        (a - m) ** 2 / jnp.exp(2 * s) + 2 * s + jnp.log(2 * jnp.pi)))(mu, log_std, action))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mb = [obs, action, (logp + 0.3 * f(NUM_ENVS)).astype(np.float32),
          (value + 0.3 * f(NUM_ENVS)).astype(np.float32), f(NUM_ENVS), f(NUM_ENVS),
          (mu + 0.1 * f(*mu.shape)).astype(np.float32),
          np.exp(log_std + 0.1 * f(*mu.shape)).astype(np.float32)]
    lr = jnp.float32(1e-3)
    vrms = JaxRMS.create(())
    # the JAX gradient: an optimizer that keeps it in its state
    real_tx = jl._tx
    jl._tx = optax.inject_hyperparams(lambda learning_rate: _grad_capture())(learning_rate=lr)
    carry, _ = jl._update_minibatch((jst.params, jl._tx.init(jst.params), lr, jrms, vrms,
                                     jnp.float32(0)), tuple(mb))
    grads = _np(carry[1].inner_state["g"])
    jl._tx = real_tx
    (jparams, _, _, _, _, _), jkl = jl._update_minibatch(
        (jst.params, jst.opt_state, lr, jrms, vrms, jnp.float32(0)), tuple(mb))

    tst = tl.init_state()
    tparams = convert.actor_critic_from_flax(_np(jst.params), "cpu")
    trms = convert.running_mean_std(jrms, "cpu")
    tmb = [T(x) for x in mb]
    tgrads, _, _ = tl._grads(tparams, trms, tmb)
    (tnew, topt, _, _, _, _), tkl = tl._update_minibatch(
        (tparams, tst.opt_state, torch.tensor(1e-3), trms, tst.value_rms, torch.tensor(0.0)), tmb)
    return dict(jgrads=convert.actor_critic_from_flax(grads, "cpu"), tgrads=tgrads,
                jparams=convert.actor_critic_from_flax(_np(jparams), "cpu"), tparams=tnew,
                jkl=float(jkl), tkl=float(tkl), topt=topt)


def test_update_gradients_match_jax(one_update):
    for k, g in one_update["tgrads"].items():
        want = one_update["jgrads"][k]
        assert float((g - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-12, k


def test_update_params_match_jax(one_update):
    assert one_update["tkl"] == pytest.approx(one_update["jkl"], rel=1e-5)
    for k, p in one_update["tparams"].items():
        want, g = one_update["jparams"][k], one_update["jgrads"][k]
        live = g.abs() > 1e-6
        assert bool(live.any())
        torch.testing.assert_close(p[live], want[live], rtol=0, atol=1e-6)
        torch.testing.assert_close(p, want, rtol=0, atol=2e-3 + 1e-6)  # at most 2 lr apart
    assert int(one_update["topt"].count) == 1


def test_clip_and_adam_match_optax():
    rng = np.random.default_rng(5)
    tl = PPOLearner(PPOConfig(**SMALL), None, device="cpu")
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8))
    jp, jopt = params, tx.init(params)
    tp = {k: T(v) for k, v in params.items()}
    topt = AdamState(torch.zeros((), dtype=torch.int32), {k: torch.zeros_like(v) for k, v in tp.items()},
                     {k: torch.zeros_like(v) for k, v in tp.items()})
    for scale in (10.0, 0.01, 3.0):  # the clip on, off, on
        g = {k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
        upd, jopt = tx.update(g, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tp, topt = tl._apply_updates(tp, topt, {k: T(v) for k, v in g.items()}, torch.tensor(1e-2))
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_kl_skip_gate_keeps_params_and_optimizer_state(one_update):
    rng = np.random.default_rng(6)
    f = lambda *s: T(rng.normal(size=s).astype(np.float32))
    mb = [f(NUM_ENVS, NUM_OBS), f(NUM_ENVS, NUM_ACT), f(NUM_ENVS), f(NUM_ENVS), f(NUM_ENVS),
          f(NUM_ENVS), f(NUM_ENVS, NUM_ACT) + 5.0, torch.full((NUM_ENVS, NUM_ACT), 0.2)]
    for factor, skipped in ((1e5, False), (1.0, True)):
        tl = PPOLearner(PPOConfig(**SMALL, kl_skip_factor=factor), None, device="cpu")
        st = tl.init_state()
        (params, opt, _, _, _, _), kl = tl._update_minibatch(
            (st.params, st.opt_state, st.lr, st.obs_rms, st.value_rms, torch.tensor(0.0)), mb)
        assert (float(kl) > factor * 0.008) == skipped
        same = all(torch.equal(params[k], st.params[k]) for k in params)
        assert same == skipped
        assert int(opt.count) == (0 if skipped else 1)
        assert all(torch.equal(opt.mu[k], st.opt_state.mu[k]) for k in params) == skipped


# ---------------------------------------------------------------- the rest
def test_act_with_injected_noise_matches_jax():
    rng = np.random.default_rng(7)
    jl, tl = _learners()
    jst = jl.init_state(jax.random.key(2))
    tst = tl.init_state()
    tst.params = convert.actor_critic_from_flax(_np(jst.params), "cpu")
    obs = rng.normal(size=(NUM_ENVS, NUM_OBS)).astype(np.float32)
    key = jax.random.key(3)
    want = [np.asarray(v) for v in jl.act(jst, obs, key)]
    noise = np.array(jax.random.normal(key, want[0].shape))
    got = tl.act(tst, T(obs), noise=T(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.act_deterministic(tst, T(obs)).numpy(),
                               np.asarray(jl.act_deterministic(jst, obs)), atol=1e-5)


def test_device_breakdown_matches_jax():
    rng = np.random.default_rng(8)
    h, n, c = 6, 5, 3
    kind = rng.integers(0, 5, (h, n))  # 0..2 a termination type, else running
    ex = {"success": kind == 0, "failure": kind == 1, "timeout": kind == 2,
          "reward_components_packed": rng.normal(size=(h, n, c)).astype(np.float32)}
    names = ("a", "b_weighted", "c")
    jb = JaxBreakdown.create(ex, comp_names=names)
    tb = DeviceBreakdown.create({k: T(v) for k, v in ex.items()}, comp_names=names)
    for _ in range(2):
        jb.update(ex)
        tb.update({k: T(v) for k, v in ex.items()})
        want, got = jb.fetch_and_reset(7), tb.fetch_and_reset(7)
        np.testing.assert_array_equal(got["ep_count"], np.asarray(want["ep_count"]))
        np.testing.assert_allclose(got["step_sum"], np.asarray(want["step_sum"]))
        for k in names:
            np.testing.assert_allclose(got["comp_sum"][k], want["comp_sum"][k], rtol=1e-6)
        assert got["global_step"] == 7


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, key, value, step):
        self.scalars.append((key, round(float(value), 5), int(step)))


def test_reward_observer_logs_as_jax():
    """Both consumption paths write the JAX observer's TensorBoard scalars."""
    rng = np.random.default_rng(9)
    h, n = 8, 6
    kind = rng.integers(0, 6, (h, n))
    ex = {"success": kind == 0, "failure": kind == 1, "timeout": kind == 2,
          "reward_components": {k: rng.normal(size=(h, n)).astype(np.float32)
                                for k in ("a", "a_weighted", "b")}}
    jw, tw = _Writer(), _Writer()
    JaxObserver(jw, log_interval=1).process_rollout(ex)
    RewardComponentObserver(tw, log_interval=1).process_rollout(ex)
    assert tw.scalars == jw.scalars and tw.scalars
    tb = DeviceBreakdown.create({"reward_components": {k: T(v) for k, v in
                                                       ex["reward_components"].items()}})
    tb.update({k: (T(v) if k != "reward_components" else {c: T(x) for c, x in v.items()})
               for k, v in ex.items()})
    jb = JaxBreakdown.create(ex)
    jb.update(ex)
    jw, tw = _Writer(), _Writer()
    JaxObserver(jw).process_device_window(jb.fetch_and_reset(48))
    RewardComponentObserver(tw).process_device_window(tb.fetch_and_reset(48))
    assert tw.scalars == jw.scalars and tw.scalars


def test_checkpoint_round_trip(tmp_path):
    tl = PPOLearner(PPOConfig(**SMALL), None, seed=3, device="cpu")
    st = tl.init_state()
    st.lr = torch.tensor(1.5e-4)
    st.opt_state.count += 4
    torch.randn(3, generator=tl.generator)
    path = str(tmp_path / "nn" / "x.pt")
    save_checkpoint(path, st, {"iteration": 9, "difficulty": 0.55}, tl)
    want_next = torch.randn(3, generator=tl.generator)
    other = PPOLearner(PPOConfig(**SMALL), None, seed=4, device="cpu")
    back = load_checkpoint(path, other.init_state(), other)
    assert all(torch.equal(back.params[k], st.params[k]) for k in st.params)
    assert int(back.opt_state.count) == 4 and float(back.lr) == pytest.approx(1.5e-4)
    assert torch.equal(torch.randn(3, generator=other.generator), want_next)
    assert load_checkpoint_meta(path) == {"iteration": 9, "difficulty": 0.55}
    small = PPOLearner(PPOConfig(**{**SMALL, "units": (8,)}), None, device="cpu")
    with pytest.raises(ValueError):
        load_checkpoint(path, small.init_state())


# toy problem (tests/test_ppo.py): reward = -|action - obs[:2]|^2, obs a
# random walk, so the reward improves only if the learner learns
TOY = dict(num_actions=2, num_obs=4, num_envs=16, horizon_length=8, minibatch_size=32,
           mini_epochs=2, units=(32, 32))


def _toy_env(seed):
    gen = torch.Generator().manual_seed(seed)

    def step(state, actions):
        reward = -((actions - state[:, :2]) ** 2).sum(-1)
        new = torch.randn(state.shape, generator=gen)
        return new, new, reward, torch.zeros(state.shape[0], dtype=torch.bool), {
            "timeout": torch.zeros(state.shape[0], dtype=torch.bool)}

    obs = torch.randn(16, 4, generator=gen)
    return step, obs


def test_learning_improves_reward():
    step, obs = _toy_env(2)
    lrn = PPOLearner(PPOConfig(**TOY), step, seed=0, device="cpu")
    st, state = lrn.init_state(), obs
    rewards = []
    for _ in range(60):
        st, state, obs, metrics, _ = lrn.train_iteration(st, state, obs)
        rewards.append(float(metrics["reward_mean"]))
    assert int(st.epoch) == 60 and all(np.isfinite(rewards))
    early, late = np.mean(rewards[:5]), np.mean(rewards[-5:])
    assert late > early + 0.3, f"no learning: early={early:.3f} late={late:.3f}"


@pytest.mark.parametrize("schedule_type", ["standard", "legacy", "per_iteration"])
def test_schedule_types_run_and_adapt(schedule_type):
    step, obs = _toy_env(4)
    lrn = PPOLearner(PPOConfig(**TOY, schedule_type=schedule_type), step, device="cpu")
    st, state, lrs = lrn.init_state(), obs, []
    for _ in range(10):
        st, state, obs, _, _ = lrn.train_iteration(st, state, obs)
        lrs.append(float(st.lr))
    assert all(1e-6 <= lr <= 1e-2 for lr in lrs)
    assert len(set(round(lr, 10) for lr in lrs)) > 1


@pytest.mark.parametrize("shuffle", ["permutation", "affine", "perm_roll", "rotation"])
def test_shuffle_modes_and_chunked_step(shuffle):
    step, obs = _toy_env(5)
    lrn = PPOLearner(PPOConfig(**TOY, shuffle=shuffle), step, device="cpu")
    st, state = lrn.init_state(), obs
    idx = lrn._epoch_index(128)
    assert sorted(idx.tolist()) == list(range(128))  # a bijection of the batch
    st, state, obs, metrics, extras = lrn.make_chunked_train_step(2)(st, state, obs)
    assert int(st.epoch) == 2 and extras["timeout"].shape == (16, 16)
    assert all(math.isfinite(float(v)) for v in metrics.values())
    rollout_s, update_s = lrn.iteration_seconds()
    assert rollout_s > 0 and update_s > 0

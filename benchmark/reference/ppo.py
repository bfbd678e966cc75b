"""The PPO learner's math in plain PyTorch, the reference of the training
cell: the actor-critic's forward, the rollout's sampled actions and value
bootstrap, GAE, the running moments, the clipped loss with the value clip
and bounds loss, global-norm clipping, Adam and the KL-adaptive learning
rate, with rl_games' semantics as the port's `rl/ppo.py` states them.

It follows the port's rollout step by step: it reads the observations,
rewards, dones and timeouts the port's env steps returned (each of which
the env-step comparison judges at sampled steps) and the noise and
shuffles the benchmark drew. Parameters are a dict keyed as the port's
network names them. `precision="tf32"` rounds every matmul's inputs to
TF32 (10 mantissa bits), the control of the training cell."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.plain.utils.config import get_by_path


@dataclasses.dataclass(frozen=True)
class Hyper:
    num_obs: int
    num_states: int
    num_actions: int
    num_envs: int
    horizon: int
    minibatch: int
    mini_epochs: int
    units: tuple
    gamma: float
    tau: float
    lr: float
    kl_threshold: float
    lr_floor: float
    lr_ceiling: float
    e_clip: float
    grad_norm: float
    critic_coef: float
    entropy_coef: float
    bounds_loss_coef: float
    reward_scale: float


def hyper_from(cfg, num_obs: int, num_states: int, num_actions: int) -> Hyper:
    """The recipe's hyper-parameters, from the reference's config tree. The
    reference implements the recipe's choices only and refuses others."""
    tp = get_by_path(cfg, "train.params.config", {}) or {}
    need = {"lr_schedule": "adaptive", "schedule_type": "standard", "shuffle": "permutation",
            "normalize_input": True, "normalize_value": True, "normalize_advantage": True,
            "value_bootstrap": True, "clip_value": True, "truncate_grads": True,
            "value_clip_sigma": None, "kl_skip_factor": None}
    for k, v in need.items():
        if tp.get(k, v) != v:
            raise NotImplementedError(f"the reference implements {k}={v!r}, not {tp.get(k)!r}")
    if str(get_by_path(cfg, "train.params.network.dtype", "float32")) != "float32":
        raise NotImplementedError("the reference implements a float32 network")
    n = int(get_by_path(cfg, "env.numEnvs"))
    return Hyper(
        num_obs=num_obs, num_states=num_states, num_actions=num_actions, num_envs=n,
        horizon=int(tp.get("horizon_length", 16)),
        minibatch=int(tp.get("minibatch_size") or n),
        mini_epochs=int(tp.get("mini_epochs", 4)),
        units=tuple(get_by_path(cfg, "train.params.network.units", [512, 256, 128])),
        gamma=float(tp.get("gamma", 0.99)), tau=float(tp.get("tau", 0.95)),
        lr=float(tp.get("learning_rate", 3e-4)),
        kl_threshold=float(tp.get("kl_threshold", 0.008)),
        lr_floor=float(tp.get("lr_floor", 1e-6)), lr_ceiling=float(tp.get("lr_ceiling", 1e-2)),
        e_clip=float(tp.get("e_clip", 0.2)), grad_norm=float(tp.get("grad_norm", 1.0)),
        critic_coef=float(tp.get("critic_coef", 4.0)),
        entropy_coef=float(tp.get("entropy_coef", 0.0)),
        bounds_loss_coef=float(tp.get("bounds_loss_coef", 1e-4)),
        reward_scale=float(tp.get("reward_shaper_scale", 1.0)))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest); the
    rounding passes gradients through unchanged."""
    d = x.detach().contiguous()
    r = ((d.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - d)


@contextlib.contextmanager
def exact_matmuls():
    """float32 matmuls without TF32, whatever the process set."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


@dataclasses.dataclass
class Moments:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(shape, device):
        return Moments(torch.zeros(shape, device=device), torch.ones(shape, device=device),
                       torch.tensor(1e-4, device=device))

    def update(self, b_mean, b_var, b_count):
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = self.var * self.count + b_var * b_count + delta ** 2 * (self.count * b_count / tot)
        return Moments(self.mean + delta * (b_count / tot), m2 / tot, tot)

    def normalize(self, x, clip=5.0):
        return ((x - self.mean) / torch.sqrt(self.var + 1e-5)).clamp(-clip, clip)

    def denormalize(self, x):
        return x * torch.sqrt(self.var + 1e-5) + self.mean


class Reference:
    """The learner's state and math. Per minibatch update it keeps the loss
    and the learning rate applied (`losses`, `lrs`); `first_grads` holds the
    clipped gradients of the first update and `snapshots[k]` the parameters
    after the k-th, for each k in `keep_after`."""

    def __init__(self, hp: Hyper, params: Dict[str, torch.Tensor], precision: str = "f32",
                 keep_after=()):
        self.hp, self.precision = hp, precision
        dev = next(iter(params.values())).device
        self.params = {k: v.detach().clone().float() for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.lr = torch.tensor(hp.lr, device=dev)
        self.obs_rms = Moments.create((hp.num_obs + hp.num_states,), dev)
        self.value_rms = Moments.create((), dev)
        self.losses: List[torch.Tensor] = []
        self.lrs: List[torch.Tensor] = []
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None
        self.keep_after = set(keep_after)
        self.snapshots: Dict[int, Dict[str, torch.Tensor]] = {}

    # -- the network ----------------------------------------------------
    def _dense(self, p, name, x):
        w, b = p[f"layers.{name}.weight"], p[f"layers.{name}.bias"]
        if self.precision == "tf32":
            x, w = tf32(x), tf32(w)
        return x @ w.t() + b

    def _trunk(self, p, prefix, x):
        for i in range(len(self.hp.units)):
            x = F.elu(self._dense(p, f"{prefix}_{i}", x))
        return x

    def forward(self, p, obs_norm):
        hp = self.hp
        if hp.num_states:
            a = self._trunk(p, "actor", obs_norm[..., :hp.num_obs])
            c = self._trunk(p, "critic", obs_norm[..., hp.num_obs:])
            heads = ("mu", "value")
        else:
            a = c = self._trunk(p, "Dense", obs_norm)
            k = len(hp.units)
            heads = (f"Dense_{k}", f"Dense_{k + 1}")
        mu = self._dense(p, heads[0], a)
        value = self._dense(p, heads[1], c)[..., 0]
        log_std = p["log_std"].clamp(-5.0, 2.0).expand(mu.shape)
        return mu, log_std, value

    @staticmethod
    def log_prob(mu, log_std, action):
        var = torch.exp(2 * log_std)
        return (-0.5 * ((action - mu) ** 2 / var + 2 * log_std
                        + math.log(2 * math.pi))).sum(-1)

    # -- one iteration ----------------------------------------------------
    def act(self, obs, noise):
        """The rollout's sampled action (before the env's clamp), its log
        probability, the value and the Gaussian's mean and std."""
        with torch.no_grad():
            mu, log_std, value = self.forward(self.params, self.obs_rms.normalize(obs))
            action = mu + torch.exp(log_std) * noise
            return action, self.log_prob(mu, log_std, action), value, mu, torch.exp(log_std)

    def iteration(self, obs_seq, noise, rewards, dones, timeouts, last_obs, perms):
        """One PPO iteration over the port's rollout: obs_seq (T, N, D) the
        observations each step acted on, noise (T, N, A), rewards, dones,
        timeouts (T, N) as the env steps returned them, last_obs (N, D) and
        the `mini_epochs` permutations of the flat batch. Returns the
        sampled actions (T, N, A), clamped as the env receives them."""
        hp = self.hp
        with exact_matmuls():
            acts = [self.act(obs_seq[t], noise[t]) for t in range(hp.horizon)]
            action, logp, value, mu, sigma = (torch.stack(x) for x in zip(*acts))
            with torch.no_grad():
                v_boot = self.value_rms.denormalize(value)
                reward = rewards * hp.reward_scale + hp.gamma * v_boot * timeouts.float()
                last_value = self.forward(self.params, self.obs_rms.normalize(last_obs))[2]
                values = self.value_rms.denormalize(value)
                next_value = self.value_rms.denormalize(last_value)
                adv, advs = torch.zeros_like(next_value), [None] * hp.horizon
                for t in reversed(range(hp.horizon)):
                    nd = 1.0 - dones[t].float()
                    delta = reward[t] + hp.gamma * next_value * nd - values[t]
                    adv = delta + hp.gamma * hp.tau * nd * adv
                    advs[t], next_value = adv, values[t]
                advantages = torch.stack(advs)
                returns = advantages + values
                flat_obs = obs_seq.reshape(-1, obs_seq.shape[-1])
                new_obs_rms = self.obs_rms.update(
                    flat_obs.mean(0), ((flat_obs - flat_obs.mean(0)) ** 2).mean(0),
                    torch.tensor(float(flat_obs.shape[0]), device=flat_obs.device))
                r = returns.reshape(-1)
                new_value_rms = self.value_rms.update(
                    r.mean(), ((r - r.mean()) ** 2).mean(),
                    torch.tensor(float(r.shape[0]), device=r.device))
                returns_norm = self.value_rms.normalize(returns, clip=math.inf)
                am = advantages.mean()
                advantages = (advantages - am) / (torch.sqrt(((advantages - am) ** 2).mean())
                                                  + 1e-8)
            flat = lambda x: x.reshape((-1,) + x.shape[2:])
            data = [flat(obs_seq), flat(action), flat(logp), flat(value), flat(advantages),
                    flat(returns_norm), flat(mu), flat(sigma)]
            batch = data[0].shape[0]
            n_mb = max(1, batch // hp.minibatch)
            for e in range(hp.mini_epochs):
                mbs = [x[perms[e]].reshape((n_mb, batch // n_mb) + x.shape[1:]) for x in data]
                kl_sum = torch.zeros((), device=data[0].device)
                for j in range(n_mb):
                    kl_sum = kl_sum + self._minibatch([x[j] for x in mbs])
                kl = kl_sum / n_mb
                self.lr = torch.where(kl > 2.0 * hp.kl_threshold, self.lr / 1.5, self.lr)
                self.lr = torch.where(kl < 0.5 * hp.kl_threshold, self.lr * 1.5, self.lr)
                self.lr = self.lr.clamp(hp.lr_floor, hp.lr_ceiling)
        self.obs_rms, self.value_rms = new_obs_rms, new_value_rms
        return action.clamp(-1.0, 1.0)

    def _minibatch(self, mb):
        hp = self.hp
        obs, action, old_logp, old_value, advantage, ret, mu_old, sigma_old = mb
        leaves = {k: v.detach().requires_grad_() for k, v in self.params.items()}
        with torch.enable_grad():
            mu, log_std, value = self.forward(leaves, self.obs_rms.normalize(obs))
            ratio = torch.exp(self.log_prob(mu, log_std, action) - old_logp)
            a_loss = -torch.minimum(advantage * ratio,
                                    advantage * ratio.clamp(1 - hp.e_clip, 1 + hp.e_clip)).mean()
            v_clip = old_value + (value - old_value).clamp(-hp.e_clip, hp.e_clip)
            c_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
            entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1).mean()
            b_loss = ((mu.abs() - 1.1).clamp(min=0.0) ** 2).sum(-1).mean()
            total = (a_loss + hp.critic_coef * c_loss - hp.entropy_coef * entropy
                     + hp.bounds_loss_coef * b_loss)
            grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        with torch.no_grad():
            sigma = torch.exp(log_std)
            kl = (torch.log(sigma / sigma_old + 1e-5)
                  + (sigma_old ** 2 + (mu_old - mu) ** 2) / (2.0 * sigma ** 2 + 1e-5)
                  - 0.5).sum(-1).mean()
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            keep = g_norm < hp.grad_norm
            grads = {k: torch.where(keep, g, g / g_norm * hp.grad_norm) for k, g in grads.items()}
            if self.first_grads is None:
                self.first_grads = {k: g.clone() for k, g in grads.items()}
            self.count += 1
            # optax's bias corrections, in float32 as the step count is
            b1, b2 = 0.9, 0.999
            c = torch.tensor(float(self.count), device=self.lr.device)
            bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
            for k, g in grads.items():
                self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
                self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
                self.params[k] = self.params[k] - self.lr * (
                    (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8))
            self.losses.append(total.detach())
            self.lrs.append(self.lr.clone())
            if self.count in self.keep_after:
                self.snapshots[self.count] = {k: v.clone() for k, v in self.params.items()}
        return kl


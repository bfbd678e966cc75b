"""PPO learner (torch): the port of `dexrobot_isaac_tpu/rl/ppo.py`.

Rollout + GAE + clipped-surrogate updates with rl_games' semantics
(cfg/train/BaseTaskPPO.yaml:33-72): gamma 0.99 / tau 0.95, horizon 16,
minibatch = num_envs, 4 mini-epochs, the KL-adaptive LR (x1.5 steps, three
schedule types), ratio and value clipping, the bounds loss, obs and value
running-stat normalization and the value bootstrap on timeouts.

What differs from the JAX learner, and why:
- The rollout is a Python loop over `horizon_length` env steps and the
  minibatch updates a loop over minibatches: PyTorch runs eagerly, and
  nothing in an iteration waits for the host (the KL gate, the LR schedule
  and the shuffles stay on the device).
- Random draws (action noise, permutations, shifts, affine multipliers)
  come from the learner's `torch.Generator` through `_randn`, `_randperm`
  and `_randint`, which a test may replace to feed the JAX learner's draws.
  The `affine` multiplier table and the `rotation` static permutation come
  from numpy with the JAX learner's seeds, so they equal its tables.
- The optimizer is optax's `chain(clip_by_global_norm, adam)` written out
  (`_apply_updates`, `ops/clip_adam.py`): the clip keeps g where ||g|| <
  max_norm and scales it by max_norm / ||g|| otherwise (no 1e-6 in the
  norm, unlike `torch.nn.utils.clip_grad_norm_`), then Adam with b1 0.9,
  b2 0.999 and eps 1e-8 outside the square root, at the carried LR. On the
  card the clip and Adam run in one hand-written kernel pair over every
  leaf (`csrc/clip_adam.cu`: the norm's partial sums, then the update), in
  the plain version's arithmetic order element by element; on the CPU in
  the plain version's eager per-leaf ops.

Across ranks (`group`, parallel/mesh.py; JAX `axis_name` under shard_map):
each rank rolls out its shard of the envs and updates its local slice of
every global minibatch (`cfg.num_envs` is the global count, so the
minibatch count is global), and the learner all-reduces where the JAX
learner's `_pmean`/`psum` stand: the gradients with the minibatch's KL in
one flat all-reduce before the clip and Adam (JAX :407, :416), the
advantage mean and variance (:473-474), the running stats' batch moments
(:634-642; the count summed) and the iteration metrics (:584-588). So the
parameters, optimizer state, running stats and LR stay bitwise equal on
every rank, and the KL gate and the LR schedule decide alike. The weights
are drawn from `seed` alone; the rollout noise and the shuffles from the
rank's own generator (JAX folds the shard index into `roll_key` and
`perm_key`, :434-436), whose seed on rank 0 is `seed` itself.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.ops.clip_adam import clip_adam
from dexrobot_isaac_tpu_torch.parallel.mesh import Group, single_process
from dexrobot_isaac_tpu_torch.rl.networks import ActorCritic
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd
from dexrobot_isaac_tpu_torch.utils.config import get_by_path
from dexrobot_isaac_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_KL = "policy_kl"  # the KL's key beside the gradients in one all-reduce


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX PPOConfig's fields and defaults (rl/ppo.py:37-122)."""

    num_actions: int
    num_obs: int
    num_envs: int
    num_states: int = 0
    horizon_length: int = 16
    minibatch_size: Optional[int] = None
    mini_epochs: int = 4
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    lr_schedule: str = "adaptive"          # adaptive | fixed
    schedule_type: str = "standard"        # standard | legacy | per_iteration
    kl_threshold: float = 0.008
    lr_floor: float = 1e-6
    lr_ceiling: float = 1e-2
    e_clip: float = 0.2
    grad_norm: float = 1.0
    critic_coef: float = 4.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 1e-4
    clip_value: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = True
    value_clip_sigma: Optional[float] = None
    kl_skip_factor: Optional[float] = None
    truncate_grads: bool = True
    shuffle: str = "permutation"   # permutation | affine | perm_roll | rotation
    units: Tuple[int, ...] = (512, 256, 128)
    network_dtype: str = "float32"
    reward_shaper_scale: float = 1.0

    @property
    def obs_width(self) -> int:
        return self.num_obs + self.num_states

    @property
    def batch_size(self) -> int:
        return self.horizon_length * self.num_envs

    @property
    def minibatch(self) -> int:
        return self.minibatch_size or self.num_envs


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the step count and both moments."""

    count: torch.Tensor            # () int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class PPOState:
    """Learner state threaded through train iterations."""

    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    lr: torch.Tensor               # () float32, adaptive
    epoch: torch.Tensor            # () int32


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor            # normalized-space value prediction
    reward: torch.Tensor           # shaped reward (+ bootstrap)
    done: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


def _gaussian_log_prob(mu, log_std, action):
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mu) ** 2 / var + 2 * log_std + math.log(2 * math.pi))).sum(-1)


def _policy_kl(mu, sigma, mu_old, sigma_old):
    """rl_games policy_kl: mean KL between diagonal Gaussians."""
    c1 = torch.log(sigma / sigma_old + 1e-5)
    c2 = (sigma_old ** 2 + (mu_old - mu) ** 2) / (2.0 * sigma ** 2 + 1e-5)
    return (c1 + c2 - 0.5).sum(-1).mean()


class PPOLearner:
    def __init__(self, cfg: PPOConfig, env_step: Callable, seed: int = 42, device="cuda",
                 group: Optional[Group] = None):
        """env_step: (env_state, actions) -> (env_state, obs, rew, done,
        extras). The learner's tensors and generator live on `device`: the
        card unless the caller passes "cpu". `group`: the ranks whose
        envs this learner trains with (none: a single process)."""
        self.cfg = cfg
        self.env_step = env_step
        self.device = resolve_device(device)
        self.group = group if group is not None else single_process(self.device)
        self._seed = seed
        # the weights are drawn on the CPU, so a seed gives the same
        # network on every device
        self.network = ActorCritic(
            cfg.obs_width - cfg.num_states, cfg.num_actions, tuple(cfg.units), cfg.num_states,
            _DTYPES[cfg.network_dtype], generator=torch.Generator().manual_seed(seed),
        ).to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.group.rank_seed(seed))
        self.comp_names: Optional[Tuple[str, ...]] = None
        self._marks = None
        self._static_perm_np = None
        self._affine_mults_np = None

    # ------------------------------------------------------------------
    # random draws (a test may replace these to feed the JAX learner's)
    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _randperm(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)

    def _randint(self, high: int) -> torch.Tensor:
        return torch.randint(0, high, (), generator=self.generator, device=self.device)

    # ------------------------------------------------------------------
    def init_state(self) -> PPOState:
        cfg = self.cfg
        params = {k: v.detach().clone() for k, v in self.network.named_parameters()}
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return PPOState(
            params=params,
            opt_state=AdamState(torch.zeros((), dtype=torch.int32, device=self.device),
                                zeros(), zeros()),
            obs_rms=RunningMeanStd.create((cfg.obs_width,), self.device),
            value_rms=RunningMeanStd.create((), self.device),
            lr=torch.tensor(cfg.learning_rate, dtype=torch.float32, device=self.device),
            epoch=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def broadcast_state(self, state: PPOState) -> PPOState:
        """Overwrite `state` with rank 0's, in place (after init or a
        checkpoint load: every rank then starts from the same state)."""
        opt = state.opt_state
        self.group.broadcast_([*state.params.values(), opt.count, *opt.mu.values(),
                               *opt.nu.values(), *state.obs_rms.to_dict().values(),
                               *state.value_rms.to_dict().values(), state.lr, state.epoch])
        return state

    def set_generator_state(self, saved: torch.Tensor, epoch: int) -> None:
        """Continue a checkpoint's generator. A checkpoint holds rank 0's; every
        other rank reseeds from its rank and the saved epoch, so the ranks'
        draws stay apart."""
        if self.group.is_main:
            self.generator.set_state(saved)
        else:
            self.generator.manual_seed(self.group.rank_seed(self._seed + epoch))

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor):
        """The network with `params` (flax's `apply`)."""
        return torch.func.functional_call(self.network, params, (x,))

    def _forward(self, params, obs_rms: RunningMeanStd, obs):
        x = obs_rms.normalize(obs) if self.cfg.normalize_input else obs
        return self.apply(params, x)

    @torch.no_grad()
    def act(self, state: PPOState, obs, noise: Optional[torch.Tensor] = None):
        """Sample actions for the rollout; `noise` (standard normal, the
        shape of mu) is drawn from the generator when omitted."""
        mu, log_std, value = self._forward(state.params, state.obs_rms, obs)
        sigma = torch.exp(log_std)
        if noise is None:
            noise = self._randn(mu.shape)
        action = mu + sigma * noise
        return action, _gaussian_log_prob(mu, log_std, action), value, mu, sigma

    @torch.no_grad()
    def act_deterministic(self, state: PPOState, obs):
        """Greedy action for evaluation (rl_games player semantics)."""
        mu, _, _ = self._forward(state.params, state.obs_rms, obs)
        return mu.clamp(-1.0, 1.0)

    # ------------------------------------------------------------------
    def _clip_v(self, v):
        s = self.cfg.value_clip_sigma
        return v if s is None else v.clamp(-s, s)

    @torch.no_grad()
    def _rollout(self, ppo: PPOState, env_state, obs):
        cfg = self.cfg
        steps, extras = [], []
        for _ in range(cfg.horizon_length):
            action, log_prob, value, mu, sigma = self.act(ppo, obs)
            env_state, next_obs, reward, done, ex = self.env_step(env_state, action.clamp(-1.0, 1.0))
            reward = reward * cfg.reward_shaper_scale
            if cfg.value_bootstrap:
                # rl_games: bootstrap the value on timeout terminations
                timeout = ex["timeout"].float()
                v = (ppo.value_rms.denormalize(self._clip_v(value)) if cfg.normalize_value
                     else value)
                reward = reward + cfg.gamma * v * timeout
            steps.append(Transition(obs, action, log_prob, value, reward, done, mu, sigma))
            extras.append(self._slim_extras(ex))
            obs = next_obs
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        return env_state, obs, traj, {k: torch.stack([e[k] for e in extras]) for k in extras[0]}

    def _slim_extras(self, extras):
        """The extras the training loop consumes, the reward components
        packed into one (N, C) tensor (sorted names, as the fused step packs
        them; `self.comp_names` records the order)."""
        if "reward_components_packed" in extras:
            packed = extras["reward_components_packed"]
        elif "reward_components" in extras:
            self.comp_names = tuple(sorted(extras["reward_components"]))
            packed = torch.stack([extras["reward_components"][k] for k in self.comp_names], -1)
        else:  # synthetic envs in tests may not provide components
            packed = None
        slim = {k: extras[k] for k in ("success", "failure", "timeout", "success_strict",
                                       "done_strict") if k in extras}
        if packed is not None:
            slim["reward_components_packed"] = packed
        return slim

    def _gae(self, ppo: PPOState, traj: Transition, last_value):
        cfg = self.cfg
        values = traj.value
        if cfg.normalize_value:
            values = ppo.value_rms.denormalize(self._clip_v(values))
            last_value = ppo.value_rms.denormalize(self._clip_v(last_value))
        next_value, adv = last_value, torch.zeros_like(last_value)
        advantages = [None] * cfg.horizon_length
        for t in reversed(range(values.shape[0])):
            not_done = 1.0 - traj.done[t].float()
            delta = traj.reward[t] + cfg.gamma * next_value * not_done - values[t]
            adv = delta + cfg.gamma * cfg.tau * not_done * adv
            advantages[t], next_value = adv, values[t]
        advantages = torch.stack(advantages)
        return advantages, advantages + values

    # ------------------------------------------------------------------
    def _loss(self, params, obs_rms: RunningMeanStd, mb):
        cfg = self.cfg
        obs, action, old_log_prob, old_value_norm, advantage, return_norm, _, _ = mb
        mu, log_std, value = self._forward(params, obs_rms, obs)
        log_prob = _gaussian_log_prob(mu, log_std, action)
        ratio = torch.exp(log_prob - old_log_prob)
        surr1 = advantage * ratio
        surr2 = advantage * ratio.clamp(1 - cfg.e_clip, 1 + cfg.e_clip)
        a_loss = -torch.minimum(surr1, surr2).mean()
        if cfg.clip_value:
            v_clipped = old_value_norm + (value - old_value_norm).clamp(-cfg.e_clip, cfg.e_clip)
            v_loss = torch.maximum((value - return_norm) ** 2, (v_clipped - return_norm) ** 2)
        else:
            v_loss = (value - return_norm) ** 2
        c_loss = 0.5 * v_loss.mean()
        entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1).mean()
        b_loss = ((mu.abs() - 1.1).clamp(min=0.0) ** 2).sum(-1).mean()
        total = (a_loss + cfg.critic_coef * c_loss - cfg.entropy_coef * entropy
                 + cfg.bounds_loss_coef * b_loss)
        return total, mu.detach(), torch.exp(log_std).detach()

    def _grads(self, params, obs_rms: RunningMeanStd, mb):
        """(grads by name, mu, sigma) of the minibatch loss at `params`."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            total, mu, sigma = self._loss(leaves, obs_rms, mb)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return dict(zip(leaves, grads)), mu, sigma

    def _apply_updates(self, params, opt: AdamState, grads, lr):
        """optax chain(clip_by_global_norm, adam) at learning rate `lr`, then
        apply_updates (`ops/clip_adam.py`): the new (params, AdamState)."""
        cfg = self.cfg
        new, count, mu, nu = clip_adam(params, grads, opt.mu, opt.nu, opt.count, lr,
                                       cfg.grad_norm if cfg.truncate_grads else None)
        return new, AdamState(count, mu, nu)

    def _global_grads(self, params, obs_rms: RunningMeanStd, mb):
        """(grads, kl) of the minibatch at `params`, each the mean over the
        ranks (JAX :407, :416), in one all-reduce: the KL is of the
        pre-update params, so it is ready with the gradients."""
        grads, mu, sigma = self._grads(params, obs_rms, mb)
        red = self.group.all_reduce_mean({**grads, _KL: _policy_kl(mu, sigma, mb[6], mb[7])})
        return {k: red[k] for k in grads}, red[_KL]

    @torch.no_grad()
    def _update_minibatch(self, carry, mb):
        """carry = (params, opt_state, lr, obs_rms, value_rms, kl_sum) ->
        (carry, kl), as the JAX scan body."""
        params, opt_state, lr, obs_rms, value_rms, kl_sum = carry
        cfg = self.cfg
        grads, kl = self._global_grads(params, obs_rms, mb)
        new_params, new_opt = self._apply_updates(params, opt_state, grads, lr)
        # past the gate another step can only push further out, so the old
        # params and optimizer state stay
        if cfg.kl_skip_factor is not None:
            skip = kl > cfg.kl_skip_factor * cfg.kl_threshold
            keep = lambda new, old: {k: torch.where(skip, old[k], new[k]) for k in new}
            params = keep(new_params, params)
            opt_state = AdamState(torch.where(skip, opt_state.count, new_opt.count),
                                  keep(new_opt.mu, opt_state.mu), keep(new_opt.nu, opt_state.nu))
        else:
            params, opt_state = new_params, new_opt
        if cfg.lr_schedule == "adaptive" and cfg.schedule_type == "legacy":
            lr = self._adapt_lr(lr, kl)
        return (params, opt_state, lr, obs_rms, value_rms, kl_sum + kl), kl

    def _epoch_index(self, n: int) -> Optional[torch.Tensor]:
        """The per-epoch reindexing of the flat batch (None: keep order)."""
        shuffle = self.cfg.shuffle
        ar = torch.arange(n, device=self.device)
        if shuffle in ("rotation", "perm_roll"):
            # jnp.roll(x, shift)[i] == x[(i - shift) mod n]
            return torch.remainder(ar - self._randint(n), n)
        if shuffle == "affine":
            mults = torch.as_tensor(self._affine_mults(n).astype(np.int64), device=self.device)
            k = mults[self._randint(mults.shape[0])]
            c = self._randint(n)
            return (k * ar + c) & (n - 1)
        return self._randperm(n)

    def _advantages(self, ppo: PPOState, traj: Transition, obs):
        """GAE over the rollout, bootstrapped by the value of `obs`, the
        observation after its last step: (advantages, returns)."""
        return self._gae(ppo, traj, self._forward(ppo.params, ppo.obs_rms, obs)[2])

    def _moments(self, ppo: PPOState, traj: Transition, advantages, returns):
        """The running stats updated with this rollout's moments (they take
        effect next iteration: the minibatches see the normalizer the rollout
        used), the normalized returns and the normalized advantages."""
        cfg = self.cfg
        obs_rms, value_rms = ppo.obs_rms, ppo.value_rms
        new_obs_rms = (obs_rms.update_with_moments(*self._batch_moments(
            traj.obs.reshape(-1, cfg.obs_width))) if cfg.normalize_input else obs_rms)
        new_value_rms = (value_rms.update_with_moments(*self._batch_moments(
            returns.reshape(-1))) if cfg.normalize_value else value_rms)
        returns_norm = (value_rms.normalize(returns, clip=math.inf) if cfg.normalize_value
                        else returns)
        if cfg.normalize_advantage:
            advantages = self._normalize_advantages(advantages)
        return new_obs_rms, new_value_rms, returns_norm, advantages

    def _presort(self, data, local_batch: int):
        """`rotation` and `perm_roll`: one permutation of the flat batch per
        iteration (the static one, or a drawn one), then a cheap roll per
        epoch; the other shuffles keep the batch's order here."""
        if self.cfg.shuffle not in ("rotation", "perm_roll"):
            return data
        sp = (self._randperm(local_batch) if self.cfg.shuffle == "perm_roll"
              else torch.as_tensor(self._static_perm(local_batch), device=self.device))
        return [x[sp] for x in data]

    def _minibatches(self, data, local_batch: int, n_mb: int, local_mb: int):
        """One epoch's reindexing of the flat batch, as (n_mb, local_mb, ...)
        minibatches."""
        idx = self._epoch_index(local_batch)
        return [x[idx].reshape((n_mb, local_mb) + x.shape[1:]) for x in data]

    @torch.no_grad()
    def train_iteration(self, ppo: PPOState, env_state, obs):
        """One PPO epoch: rollout + GAE + minibatch updates + adaptive LR.
        Returns (ppo, env_state, obs, metrics, rollout extras)."""
        cfg = self.cfg
        m0 = self._mark()
        env_state, obs, traj, roll_extras = self._rollout(ppo, env_state, obs)
        m1 = self._mark()
        advantages, returns = self._advantages(ppo, traj, obs)
        new_obs_rms, new_value_rms, returns_norm, advantages = self._moments(
            ppo, traj, advantages, returns)
        obs_rms, value_rms = ppo.obs_rms, ppo.value_rms

        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        data = [flat(traj.obs), flat(traj.action), flat(traj.log_prob), flat(traj.value),
                flat(advantages), flat(returns_norm), flat(traj.mu), flat(traj.sigma)]
        local_batch = data[0].shape[0]
        n_mb = max(1, cfg.batch_size // cfg.minibatch)
        local_mb = local_batch // n_mb
        data = self._presort(data, local_batch)

        params, opt_state, lr = ppo.params, ppo.opt_state, ppo.lr
        kl = torch.zeros((), device=self.device)
        for _ in range(cfg.mini_epochs):
            mb_data = self._minibatches(data, local_batch, n_mb, local_mb)
            carry = (params, opt_state, lr, obs_rms, value_rms, torch.zeros((), device=self.device))
            for j in range(n_mb):
                carry, _ = self._update_minibatch(carry, [x[j] for x in mb_data])
            params, opt_state, lr, _, _, kl_sum = carry
            kl = kl_sum / n_mb
            if cfg.lr_schedule == "adaptive" and cfg.schedule_type == "standard":
                lr = self._adapt_lr(lr, kl)
        if cfg.lr_schedule == "adaptive" and cfg.schedule_type == "per_iteration":
            lr = self._adapt_lr(lr, kl)
        self._marks = (m0, m1, self._mark())

        new_ppo = PPOState(params, opt_state, new_obs_rms, new_value_rms, lr, ppo.epoch + 1)
        g = self.group.all_reduce_mean({
            "reward_mean": traj.reward.mean(), "value_mean": traj.value.mean(),
            "advantage_sq": (advantages ** 2).mean(),
            "episode_done_frac": traj.done.float().mean()})
        metrics = {"kl": kl, "lr": lr, "reward_mean": g["reward_mean"],
                   "value_mean": g["value_mean"], "advantage_std": torch.sqrt(g["advantage_sq"]),
                   "episode_done_frac": g["episode_done_frac"]}
        return new_ppo, env_state, obs, metrics, roll_extras

    def make_chunked_train_step(self, chunk: int):
        """`chunk` train iterations per call, with no host sync between
        them: fn(ppo, env_state, obs) -> (ppo, env_state, obs, metrics of the
        last iteration, extras of all, (chunk*T, N, ...) in time order)."""
        def run(ppo, env_state, obs):
            extras = []
            for _ in range(chunk):
                ppo, env_state, obs, metrics, ex = self.train_iteration(ppo, env_state, obs)
                extras.append(ex)
            return ppo, env_state, obs, metrics, {k: torch.cat([e[k] for e in extras])
                                                  for k in extras[0]}

        return run

    # ------------------------------------------------------------------
    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def iteration_seconds(self) -> Tuple[float, float]:
        """(rollout, update) seconds of the last train iteration: device time
        between CUDA events on the card (waits for the iteration to end),
        the host clock on the CPU."""
        m0, m1, m2 = self._marks
        if self.device.type == "cuda":
            m2.synchronize()
            return m0.elapsed_time(m1) / 1e3, m1.elapsed_time(m2) / 1e3
        return m1 - m0, m2 - m1

    def _affine_mults(self, n: int) -> np.ndarray:
        """64 odd multipliers for the affine shuffle, from the JAX learner's
        numpy seed. Needs n a power of two (`& (n-1)` is mod n)."""
        if n & (n - 1):
            raise ValueError(f"shuffle=affine requires a power-of-two batch, got {n} "
                             "(horizon_length * num_envs); use shuffle=permutation")
        if self._affine_mults_np is None or self._affine_mults_np[0] != n:
            rng = np.random.default_rng(self._seed ^ 0xA55E)
            lo = max(1, n // 8)
            mults = (rng.integers(lo, max(lo + 1, n), 64) | 1) % max(n, 2)
            self._affine_mults_np = (n, np.maximum(mults, 1).astype(np.uint32))
        return self._affine_mults_np[1]

    def _static_perm(self, n: int) -> np.ndarray:
        """The `rotation` shuffle's fixed permutation, from the JAX
        learner's numpy seed."""
        if self._static_perm_np is None or len(self._static_perm_np) != n:
            self._static_perm_np = np.random.default_rng(self._seed).permutation(n)
        return self._static_perm_np

    def _adapt_lr(self, lr, kl):
        """rl_games AdaptiveScheduler.update: +/-1.5x on KL vs threshold."""
        cfg = self.cfg
        lr = torch.where(kl > 2.0 * cfg.kl_threshold, lr / 1.5, lr)
        lr = torch.where(kl < 0.5 * cfg.kl_threshold, lr * 1.5, lr)
        return lr.clamp(cfg.lr_floor, cfg.lr_ceiling)

    def _batch_moments(self, batch):
        """The batch's mean and variance (the mean over the ranks of each
        rank's, about the global mean) and its global count (JAX :634-642)."""
        mean = self.group.all_reduce_mean(batch.mean(dim=0))
        var = self.group.all_reduce_mean(((batch - mean) ** 2).mean(dim=0))
        count = torch.tensor(float(batch.shape[0]), device=batch.device)
        return mean, var, self.group.all_reduce_sum(count)

    def _normalize_advantages(self, adv):
        """Advantages over their global mean and std (JAX :472-475)."""
        mean = self.group.all_reduce_mean(adv.mean())
        var = self.group.all_reduce_mean(((adv - mean) ** 2).mean())
        return (adv - mean) / (torch.sqrt(var) + 1e-8)


def ppo_config_from(cfg: Dict[str, Any], env) -> PPOConfig:
    """The PPOConfig of a composed config dict (train.params) for `env`
    (`num_envs` over all ranks)."""
    tp = get_by_path(cfg, "train.params.config", {}) or {}
    opt = lambda k: None if tp.get(k) is None else float(tp[k])
    return PPOConfig(
        num_actions=env.num_actions, num_obs=env.num_obs, num_states=env.num_states,
        num_envs=env.num_envs * env.group.world_size,
        horizon_length=int(tp.get("horizon_length", 16)),
        minibatch_size=tp.get("minibatch_size"),
        mini_epochs=int(tp.get("mini_epochs", 4)),
        gamma=float(tp.get("gamma", 0.99)), tau=float(tp.get("tau", 0.95)),
        learning_rate=float(tp.get("learning_rate", 3e-4)),
        lr_schedule=str(tp.get("lr_schedule", "adaptive")),
        schedule_type=str(tp.get("schedule_type", "standard")),
        kl_threshold=float(tp.get("kl_threshold", 0.008)),
        lr_floor=float(tp.get("lr_floor", 1e-6)), lr_ceiling=float(tp.get("lr_ceiling", 1e-2)),
        e_clip=float(tp.get("e_clip", 0.2)), grad_norm=float(tp.get("grad_norm", 1.0)),
        critic_coef=float(tp.get("critic_coef", 4.0)),
        entropy_coef=float(tp.get("entropy_coef", 0.0)),
        bounds_loss_coef=float(tp.get("bounds_loss_coef", 1e-4)),
        clip_value=bool(tp.get("clip_value", True)),
        normalize_input=bool(tp.get("normalize_input", True)),
        normalize_value=bool(tp.get("normalize_value", True)),
        normalize_advantage=bool(tp.get("normalize_advantage", True)),
        value_bootstrap=bool(tp.get("value_bootstrap", True)),
        value_clip_sigma=opt("value_clip_sigma"), kl_skip_factor=opt("kl_skip_factor"),
        units=tuple(get_by_path(cfg, "train.params.network.units", [512, 256, 128])),
        network_dtype=str(get_by_path(cfg, "train.params.network.dtype", "float32")),
        reward_shaper_scale=float(tp.get("reward_shaper_scale", 1.0)),
        shuffle=str(tp.get("shuffle", "permutation")),
    )

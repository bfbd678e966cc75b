"""PPO training through the CLI's own objects: `train.build(cfg)` makes the
env, its fused step (K1) and the learner, and the window drives the
learner's chunked train step (`dispatch_chunk` iterations per call, as the
CLI picks it), one host sync per call. Checkpoints, TensorBoard and the
curriculum's promotion are left out: a freshly seeded policy completes no
episode that would promote.

Set-up replaces the learner's weights with the benchmark's (drawn on the
card from the seed) and makes the first call with hooks on the learner:
its noise and shuffles come from the benchmark's generator, the checked
env steps take their reset draws from the reference env's generator, and
the first iteration's env steps and sampled actions, and its minibatch
updates' count, losses, learning rates, first optimizer state and
parameters after the first `compared_updates` updates, are kept for the
judge. The hooks are gone before the window; the same learner, state and
env go on into it.

The judge follows the first iteration's rollout, GAE and moments, holds
the number of its minibatch updates to the reference's full iteration,
compares the loss of every update of its first epoch (each sample of the
batch once) and its first `compared_updates` optimizer steps (the
training steps), all before the first epoch's KL-adaptive learning-rate
decision: a gate on a threshold that rounding can tip either way, after
which the two sides' learning rates may differ by 1.5x (see PERF.md)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import stats, trace
from benchmark.loops import common
from benchmark.reference import ppo as ref_ppo

NO_READING = 1e30
PARTS = ("_rollout", "_advantages", "_moments", "_minibatches", "_global_grads",
         "_apply_updates")


class Recorder:
    """The hooks of the first call: instance attributes over the learner's
    methods, recording the first iteration; removed by `remove`."""

    def __init__(self, learner, gen, updates: int, checked_steps, obs0, renv, fused):
        self.learner, self.renv, self.fused = learner, renv, fused
        self.it, self.t, self.updates, self.applied = 0, 0, updates, 0
        self.checked_steps = set(checked_steps)
        self.obs = [obs0.cpu()]          # what each step acted on, then the last
        self.noise, self.actions, self.rewards, self.dones, self.timeouts = [], [], [], [], []
        self.perms, self.losses, self.lrs = [], [], []
        self.first_mu = self.params = None
        self.checked = []
        self.env_step = learner.env_step
        dev = learner.device
        learner._randn = lambda shape: self._keep(
            self.noise, torch.randn(shape, generator=gen, device=dev))
        learner._randperm = lambda n: self._keep(
            self.perms, torch.randperm(n, generator=gen, device=dev))
        learner._randint = lambda high: torch.randint(0, high, (), generator=gen, device=dev)
        learner.env_step = self._env_step
        self._loss, self._apply, self._iteration = (learner._loss, learner._apply_updates,
                                                    learner.train_iteration)
        learner._loss = self._loss_hook
        learner._apply_updates = self._apply_hook
        learner.train_iteration = self._iteration_hook

    @property
    def recording(self) -> bool:
        return self.it == 0

    def _keep(self, store, x):
        if self.recording:
            store.append(x.cpu())
        return x

    def _env_step(self, state, action):
        c, operands = None, None
        if self.recording and self.t in self.checked_steps:
            samples, operands = common.reset_draws(self.renv, self.fused, state, action.shape[0])
            c = common.Checked(common.clone_fused(state), action.clone(), samples)
        out = self.env_step(state, action, operands)
        if self.recording:
            if c is not None:
                c.post, c.obs, c.rew, c.done = (common.clone_fused(out[0]), out[1].clone(),
                                                out[2].clone(), out[3].clone())
                self.checked.append(c)
            self.actions.append(action.cpu())
            self.obs.append(out[1].cpu())
            self.rewards.append(out[2].cpu())
            self.dones.append(out[3].cpu())
            self.timeouts.append(out[4]["timeout"].cpu())
            self.t += 1
        return out

    def _loss_hook(self, params, obs_rms, mb):
        out = self._loss(params, obs_rms, mb)
        if self.recording:
            self.losses.append(out[0].detach().clone())
        return out

    def _apply_hook(self, params, opt, grads, lr):
        new, new_opt = self._apply(params, opt, grads, lr)
        if self.recording:
            self.applied += 1
            self.lrs.append(lr.clone())
            if self.applied == 1:
                self.first_mu = {k: v.clone() for k, v in new_opt.mu.items()}
            if self.applied == self.updates:
                self.params = {k: v.clone() for k, v in new.items()}
        return new, new_opt

    def _iteration_hook(self, ppo, env_state, obs):
        out = self._iteration(ppo, env_state, obs)
        self.it += 1
        return out

    def remove(self):
        for name in ("_randn", "_randperm", "_randint", "_loss", "_apply_updates",
                     "train_iteration"):
            delattr(self.learner, name)
        self.learner.env_step = self.env_step


def leaf_norms(d):
    return {k: float(v.double().norm()) for k, v in d.items()}


def run(ctx):
    from dexrobot_isaac_tpu_torch import train as cli

    spec, dev, tr = ctx.spec, ctx.device, ctx.spec.traffic
    cfg = common.program_config(spec, dev, [
        f"train.seed={common.sub_seed(ctx.seed, 'learner')}", "train.logging.noLogFile=true"])
    common.build_kernels(spec.config, dev)
    s = cli.build(cfg)
    learner, fused = s.learner, s.fused
    if fused is None:
        raise RuntimeError("the training cell runs the fused step; the CLI chose the unfused one")
    if ctx.fault is not None:
        ctx.fault.wrap_learner(learner)
    st = {"ppo": s.ppo}
    weights = common.make_weights({k: v.shape for k, v in st["ppo"].params.items()},
                                  common.sub_seed(ctx.seed, "weights"), dev)
    with torch.no_grad():
        for k, v in st["ppo"].params.items():
            v.copy_(weights[k])
    n = learner.cfg.num_envs
    horizon, chunk, updates = learner.cfg.horizon_length, tr["chunk"], tr["compared_updates"]
    train_step = learner.make_chunked_train_step(chunk)
    st["env"], st["obs"] = fused.reset()

    gen = torch.Generator(device=dev).manual_seed(common.sub_seed(ctx.seed, "draws"))
    rng = np.random.default_rng(common.sub_seed(ctx.seed, "checks"))
    checked_steps = rng.choice(horizon, tr["checked_steps"], replace=False).tolist()
    renv, rcfg = common.reference_env(spec, dev, common.sub_seed(ctx.seed, "reference"))
    rec = Recorder(learner, gen, updates, checked_steps, st["obs"], renv, fused)
    st["ppo"], st["env"], st["obs"], _, _ = train_step(st["ppo"], st["env"], st["obs"])
    rec.remove()
    rec.renv = renv = None  # the window runs without the reference env; the judge makes its own
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    spans = trace.Spans() if ctx.trace else None
    learner_ms = {"rollout": [], "update": []}
    t_start = common.now()
    setup_s = t_start - ctx.t0
    calls = 0
    while True:
        st["ppo"], st["env"], st["obs"], metrics, _ = train_step(st["ppo"], st["env"], st["obs"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        calls += 1
        if ctx.trace:
            r_s, u_s = learner.iteration_seconds()
            learner_ms["rollout"].append(r_s * 1e3)
            learner_ms["update"].append(u_s * 1e3)
        if common.now() - t_start >= ctx.seconds:
            break
    t_end = common.now()
    batch = learner.cfg.batch_size
    rate = calls * chunk * batch / (t_end - t_start)
    failed = int(not np.isfinite(float(metrics["kl"])))

    record = common.Record(
        config=spec.config, traffic=tr, num_envs=n, attempted=calls * chunk, failed=failed,
        end_to_end={"train_env_steps_per_s": rate, "setup_s": setup_s}, judge=None,
        release=None, spans=spans, traced_rate=rate if ctx.trace else None,
        learner_ms=learner_ms)

    if ctx.trace:
        marks = trace.Spans()

        def spanned(name, fn):
            def wrapped(*a, **k):
                with marks.mark(name.strip("_")):
                    return fn(*a, **k)
            return wrapped

        for name in PARTS:
            setattr(learner, name, spanned(name, getattr(learner, name)))
        stretch = learner.make_chunked_train_step(tr["profiled_iterations"])
        out_trace = []
        with trace.profiled(dev, marks, out_trace):
            st["ppo"], st["env"], st["obs"], _, _ = stretch(st["ppo"], st["env"], st["obs"])
        for name in PARTS:
            delattr(learner, name)
        record.device_trace = out_trace[0]
        record.stretch_steps = tr["profiled_iterations"] * horizon

    num_obs, num_states, num_actions = learner.cfg.num_obs, learner.cfg.num_states, \
        learner.cfg.num_actions

    def release():
        st.clear()
        s.learner = s.env = s.ppo = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    hp = ref_ppo.hyper_from(rcfg, num_obs, num_states, num_actions)

    def reference(precision: str):
        return _reference_run(rec, hp, weights, precision, updates)

    def program():
        return {"losses": torch.stack(rec.losses).double().cpu(), "applied": rec.applied,
                "first_grads": {k: v / 0.1 for k, v in rec.first_mu.items()},
                "params": rec.params, "actions": torch.stack(rec.actions),
                "lrs": torch.stack(rec.lrs).cpu()}

    def judge(control: bool = False):
        ref = reference("f32")
        renv = common.reference_env(spec, dev, common.sub_seed(ctx.seed, "reference"))[0]
        out = common.step_checks(rec.checked, fused, renv, control)
        cand = reference("tf32") if control else program()
        out.update(_learner_numbers(cand, ref, weights, updates, hp.mini_epochs))
        return out

    record.diagnose = lambda: {"program": diagnostics(program(), reference("f32"), weights),
                               "control": diagnostics(reference("tf32"), reference("f32"),
                                                      weights)}

    record.release, record.judge = release, judge
    return record


def _reference_run(rec: Recorder, hp, weights, precision: str, updates: int):
    """The reference over the recorded iteration: its losses and learning
    rates per minibatch update, first clipped gradients, parameters after
    `updates` updates, and sampled actions."""
    dev = next(iter(weights.values())).device
    ref = ref_ppo.Reference(hp, weights, precision, keep_after=(updates,))
    T = hp.horizon
    to = lambda xs: torch.stack(xs[:T]).to(dev)
    acts = ref.iteration(torch.stack(rec.obs[:T]).to(dev), to(rec.noise), to(rec.rewards),
                         to(rec.dones), to(rec.timeouts), rec.obs[T].to(dev),
                         [p.to(dev) for p in rec.perms[:hp.mini_epochs]]).cpu()
    return {"losses": torch.stack(ref.losses).double().cpu(), "applied": ref.count,
            "first_grads": ref.first_grads,
            "params": ref.snapshots[updates], "actions": acts,
            "lrs": torch.stack(ref.lrs).cpu()}


def _learner_numbers(cand, ref, weights, updates: int, mini_epochs: int):
    """updates_missing: how far the candidate's count of minibatch updates
    (losses taken, and optimizer steps applied) in its first iteration is
    from the reference's full iteration (`mini_epochs` x minibatches per
    epoch). loss_gap: the widest gap of the first epoch's minibatch losses
    (every sample of the batch once), over the median of their sizes.
    grad1_gap and delta3_gap: the worst leaf's gap between the candidate's
    and the reference's norms of the first clipped gradient, and of the
    parameters' change over the first `updates` updates, each over the
    larger of the reference leaf's norm and the median leaf's; leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change. action_gap: the widest
    gap of a sampled action of the first rollout, max |a - r| / (1 + |r|)."""
    full = len(ref["losses"])
    missing = float(max(abs(len(cand["losses"]) - full), abs(cand["applied"] - full)))
    epoch = full // mini_epochs
    lc, lr = cand["losses"][:epoch], ref["losses"][:epoch]
    if lc.shape != lr.shape or cand["params"] is None:
        # no reading: a number far over any limit that JSON can still hold
        return {"updates_missing": missing, "loss_gap": NO_READING, "grad1_gap": NO_READING,
                "delta3_gap": NO_READING, "action_gap": NO_READING}
    loss_gap = float((lc - lr).abs().max() / lr.abs().median())
    g_ref = leaf_norms(ref["first_grads"])
    g_cand = leaf_norms(cand["first_grads"])
    med = float(np.median(list(g_ref.values())))
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    d_ref = leaf_norms({k: ref["params"][k] - weights[k] for k in moved})
    d_cand = leaf_norms({k: cand["params"][k] - weights[k] for k in moved})
    a_c, a_r = cand["actions"].double(), ref["actions"].double()
    return {"updates_missing": missing, "loss_gap": loss_gap,
            "grad1_gap": stats.worst_leaf_gap(g_cand, g_ref)[0],
            "delta3_gap": stats.worst_leaf_gap(d_cand, d_ref)[0],
            "action_gap": float(((a_c - a_r).abs() / (1 + a_r.abs())).max())}


def diagnostics(cand, ref, weights):
    """What the judge does not compare: each minibatch loss of the first
    iteration over the median loss's size, the updates at which the two
    sides' learning rates differ (the adaptive gate tipped), and the leaves
    whose change gaps most, with their sizes."""
    g_ref = leaf_norms(ref["first_grads"])
    d_ref = leaf_norms({k: ref["params"][k] - weights[k] for k in g_ref})
    d_c = leaf_norms({k: cand["params"][k] - weights[k] for k in g_ref})
    med = float(np.median(list(d_ref.values())))
    leaves = sorted(((abs(d_c[k] - d_ref[k]) / max(d_ref[k], med), k) for k in d_ref),
                    reverse=True)[:4]
    def apart(k):
        """The elements whose change differs by over 1e-5: their first
        reference gradient over the leaf's RMS (median), and the share whose
        first gradients differ in sign between the two sides."""
        moved = (cand["params"][k] - ref["params"][k]).abs() > 1e-5
        gr, gc = ref["first_grads"][k], cand["first_grads"][k]
        rms = float(gr.double().pow(2).mean().sqrt())
        if not bool(moved.any()):
            return {"elements_moved_apart": 0}
        return {"elements_moved_apart": int(moved.sum()),
                "their_grad_over_rms": float((gr[moved].abs() / rms).median()),
                "their_sign_flips": float((torch.sign(gr[moved]) != torch.sign(gc[moved]))
                                          .float().mean())}

    worst = [{"leaf": k, "gap": g, "ref_change": d_ref[k], "change": d_c[k],
              "ref_grad": g_ref[k], "numel": int(weights[k].numel()), **apart(k)}
             for g, k in leaves]
    n = min(len(cand["losses"]), len(ref["losses"]))
    gaps = ((cand["losses"][:n] - ref["losses"][:n]).abs() / ref["losses"][:n].abs().median())
    lr_c, lr_r = cand["lrs"][:n].double(), ref["lrs"][:n].double()
    return {"worst_leaves": worst, "median_leaf_change": med,
            "median_change_gap": float(np.median([abs(d_c[k] - d_ref[k]) / max(d_ref[k], med)
                                                  for k in d_ref])),
            "loss_gaps": [float(x) for x in gaps[:8]],
            "lr_differs_at": [int(i) for i in torch.nonzero((lr_c - lr_r).abs() > 1e-3 * lr_r)
                              .flatten()]}

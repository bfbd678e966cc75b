"""Chained env steps of the port's fused step (K1 and its wrapper), as a
framework user steps the env from their own learner: from a reset, each
`step_fn` call on the state the last returned, under uniform actions in
[-1, 1] cycled from a bank drawn on the device from the seed. Episodes end
and reset inside the window (the wrapper's masked auto-reset).

The window runs steps until `--seconds` have passed on the host clock
and the last checked step has run, then waits for the card: the rate is all its steps over all its time. One
CUDA event after each step, read once the window has closed, gives the
interval between consecutive step completions on the stream. Checked
steps (drawn from the seed, plus the step at which the first episodes
time out) take their reset draws from the reference env's generator
through the step's `operands` argument, and keep a copy of the state
before and after them for the judge."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import trace
from benchmark.loops import common


class Marks:
    """A completion mark after each step: CUDA events on the card, the host
    clock on the CPU (the tests)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events = []

    def record(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        else:
            self.events.append(common.now())

    def p95_ms(self) -> float:
        if self.cuda:
            return common.window_p95_ms(self.events)
        return float(np.percentile(np.diff(np.asarray(self.events)) * 1e3, 95))


def run(ctx):
    from dexrobot_isaac_tpu_torch.factory import make_env

    spec, dev, tr = ctx.spec, ctx.device, ctx.spec.traffic
    cfg = common.program_config(spec, dev)
    common.build_kernels(spec.config, dev)
    env = make_env(cfg, seed=common.sub_seed(ctx.seed, "env"), device=dev)
    fused = env.make_fused()
    n, n_act = env.num_envs, env.num_actions
    gen = torch.Generator(device=dev).manual_seed(common.sub_seed(ctx.seed, "actions"))
    bank = torch.rand(tr["action_bank"], n, n_act, generator=gen, device=dev) * 2 - 1
    step = fused.step_fn
    if ctx.fault is not None:
        step = ctx.fault.wrap_step(fused, step)

    st = {}
    st["fs"], _ = fused.reset()
    warm = tr["warmup_steps"]
    for i in range(warm):
        st["fs"] = step(st["fs"], bank[i % len(bank)])[0]
    rng = np.random.default_rng(common.sub_seed(ctx.seed, "checks"))
    timeout_step = int(cfg["env"]["episodeLength"]) - warm - 2  # the step that times out
    checks = {timeout_step, *rng.choice(tr["check_within"], tr["checked_random"],
                                         replace=False).tolist()}
    last_check = max(checks)
    renv, _ = common.reference_env(spec, dev, common.sub_seed(ctx.seed, "reference"))
    marks = Marks(dev)
    spans = trace.Spans() if ctx.trace else None
    checked = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t_start = common.now()
    setup_s = t_start - ctx.t0
    marks.record()
    i = 0
    while True:
        a = bank[i % len(bank)]
        operands = None
        if i in checks:
            samples, operands = common.reset_draws(renv, fused, st["fs"], n)
            c = common.Checked(common.clone_fused(st["fs"]), a, samples)
        if spans is not None:
            with spans.mark("step_fn"):
                out = step(st["fs"], a, operands)
        else:
            out = step(st["fs"], a, operands)
        st["fs"] = out[0]
        if i in checks:
            c.post, c.obs, c.rew, c.done = common.clone_fused(out[0]), out[1], out[2], out[3]
            checked.append(c)
        marks.record()
        i += 1
        if i > last_check and common.now() - t_start >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = common.now()
    rate = i * n / (t_end - t_start)

    rec = common.Record(
        config=spec.config, traffic=tr, num_envs=n, attempted=i,
        failed=sum(int(not (torch.isfinite(c.obs).all() and torch.isfinite(c.rew).all()))
                   for c in checked),
        end_to_end={"env_steps_per_s": rate, "step_ms_p95": marks.p95_ms(), "setup_s": setup_s},
        judge=None, release=None, spans=spans, traced_rate=rate if ctx.trace else None)

    if ctx.trace:
        out_trace, marks = [], trace.Spans()
        with trace.profiled(dev, marks, out_trace):
            for j in range(tr["profiled_steps"]):
                with marks.mark("step_fn"):
                    st["fs"] = step(st["fs"], bank[(i + j) % len(bank)])[0]
        rec.device_trace, rec.stretch_steps = out_trace[0], tr["profiled_steps"]

    def release():
        st.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(control: bool = False):
        return common.step_checks(checked, fused, renv, control)

    rec.release, rec.judge = release, judge
    rec.diagnose = lambda: {"resets_at_checked_steps": [int(c.done.sum()) for c in checked]}
    return rec

"""Where the lane kernels' time goes, on the card: variants of K1/K2 timed.

    python -m dexrobot_isaac_tpu_torch.utils.lane_probe [--scene grasp|stacking|both]
        [--tree NAME=DIR ...] [--variants full,none,only_ltl,...]

Needs one CUDA card and nvcc. Builds, next to the port's own build, variants
of a csrc/ tree with one source edit each (the tree itself is not changed),
one nvcc per variant and build, all at once (`kernel_build.nvcc`). The
trees are the port's csrc/ (`new`) unless `--tree` names others, such as a
parent commit's csrc/ unpacked with `git archive` under `_trees/`; each
tree's phases are read from its own lp_substep. Per scene, at 4096 envs:

- `grasp`: BlindGrasping (K1 `fused_step`, K2 `control_step`) from a
  contact-rich state (three fused steps of random actions);
- `stacking`: BoxStacking (K1 `fused_step_stacking`, K2 `control_step_box2`)
  from the state of `stacked_scene` (three fused steps of random actions,
  then a quarter of the pick cubes resting on the platform and a quarter
  dropped onto it: cube-cube, platform-ground and hand contacts).

The variants:

- `full`: the sources as they are (K1 and K2), the reference;
- `only_<phase>`: K2 with its substep cut to that one phase (a statement of
  lp_substep in lane_physics.cuh, the build's own where the substep has
  `#if LP_HAS_BOX2` branches) and the final FK and I/O kept; `none` keeps no
  phase. A variant's time less `none`'s is that phase's share of a control
  step (16 substeps); its outputs are not meaningful;
- `model_shared` (grasp only): K1 and K2 with the LaneModel copied into each
  block's shared memory first, against `full`'s read-only global path.

`--variants` keeps only the named ones (`full` alone compares the trees);
the phases' shares are printed when every variant runs.

Prints ptxas's registers, spills and stack per build and, per variant, ms
per launch (device time of 10 launches after one, `kernel_build.device_ms`),
resident blocks per SM, and for `full` and `model_shared` how far the
outputs are from the first tree's `full` (bits equal, and the largest
difference relative to the largest value); then each phase's share of the
sum of the phases, beside that sum against `full` less `none`. The last
line is a JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import sys

N_ENVS = 4096
# scene: (task, K1 build, K2 build)
SCENES = {"grasp": ("BlindGrasping", "fused_step", "control_step"),
          "stacking": ("BoxStacking", "fused_step_stacking", "control_step_box2")}

# the model_shared edit: after the env slots, each block copies the model
# into its dynamic shared memory and reads it from there
_COPY = """  LaneModel* msh = (LaneModel*)(lp_smem + LP_ENVS * {stride});
  for (int k = tid; k < (int)(sizeof(LaneModel) / 4); k += nthr)
    ((int*)msh)[k] = ((const int*)m)[k];
  __syncthreads();
  m = msh;
"""


def substep_items(lp: str):
    """lp_substep's body as a list of ("#", directive) and (phase, statement):
    a statement starts with `for` or `LP_WARP` at the body's indent, its
    phase is the first lp_ function it calls without `_phase`. Returns
    (start, end, items) with start/end the body's offsets in `lp`."""
    a = lp.index("{", lp.index("LP_DEV void lp_substep(")) + 1
    b = lp.index("\n}\n", a)
    items = []
    for chunk in re.split(r"\n(?=  (?:for|LP_WARP)| *#)", lp[a:b]):
        text = chunk.strip()
        if not text:
            continue
        if text.startswith("#"):
            if "\n" in text:
                raise RuntimeError(f"lp_substep: a directive runs into code: {text!r}")
            items.append(("#", text))
        else:
            items.append((re.search(r"\blp_(\w+?)(?:_phase)?\(", text).group(1), text))
    return a, b, items


def build_phases(items, defines) -> list:
    """The phases a build runs, in order: the statements its defines reach
    (`#if LP_HAS_BOX2` / `#if !LP_HAS_BOX2`, `#else`, `#endif`)."""
    box2 = "-DLP_HAS_BOX2=1" in defines
    stack, out = [], []
    for name, text in items:
        if name != "#":
            if all(stack):
                out.append(name)
        elif text in ("#if LP_HAS_BOX2", "#if !LP_HAS_BOX2"):
            stack.append(box2 == (text == "#if LP_HAS_BOX2"))
        elif text == "#else":
            stack[-1] = not stack[-1]
        elif text == "#endif":
            stack.pop()
        else:
            raise RuntimeError(f"lp_substep: directive not understood: {text}")
    return out


def _variants(csrc: str):
    """The tree's sources and {variant: {file: text}} of its edits."""
    src = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
           if f.endswith((".cu", ".cuh"))}
    lp = src["lane_physics.cuh"]
    a, b, items = substep_items(lp)
    keep = lambda pick: "".join(("\n" if n == "#" else "\n  ") + t for n, t in items
                                if n == "#" or pick(n)) + "\n"
    out = {"full": {}, "none": {"lane_physics.cuh": lp[:a] + keep(lambda n: False) + lp[b:]}}
    for name in dict.fromkeys(n for n, _ in items if n != "#"):
        out["only_" + name] = {"lane_physics.cuh": lp[:a] + keep(lambda n, x=name: n == x)
                               + lp[b:]}
    shared = {}
    for f, stride, slot in (("control_step.cu", "CS_STRIDE", "LpEnv"),
                            ("fused_step.cu", "FS_STRIDE", "FsEnv")):
        t = src[f]
        anchor = "  const int e0 = blockIdx.x * LP_ENVS, tid = threadIdx.x, nthr = blockDim.x;\n"
        k = t.index(anchor) + len(anchor)  # the first kernel: K2 or K1
        t = t[:k] + _COPY.format(stride=stride) + t[k:]
        size = f"LP_ENVS * (int)sizeof({slot})"
        t = t.replace(f"const int smem = {size};", f"const int smem = {size} + (int)sizeof(LaneModel);")
        t = t.replace(f"= {size};\n", f"= {size} + (int)sizeof(LaneModel);\n", 1)
        shared[f] = t
    out["model_shared"] = shared
    return src, out, items


def stacked_scene(env, state, gen):
    """A BoxStacking state with every contact kind of the two-cube scene:
    `state`'s physics with a quarter of the envs' pick cube resting on the
    platform (offset, yawed, pushed; slightly interpenetrating) and a quarter
    dropped onto it, so that cube-cube, platform-ground and hand contacts
    are all active (tests/test_pallas_step.py,
    tests/test_physics_multibody.py). Returns the new PhysicsState."""
    import torch

    ph = dataclasses.replace(state.physics)
    n, dev = ph.q.shape[0], ph.q.device
    t = env.comps.task
    top = t.plat_size + t.box_size / 2.0
    rest, drop = torch.arange(n, device=dev) % 4 == 0, torch.arange(n, device=dev) % 4 == 1
    off = (torch.rand(n, 2, generator=gen, device=dev) * 2 - 1) * 0.01
    pos = torch.cat([ph.box2_pos[:, :2] + off, ph.box2_pos[:, 2:3] * 0 + top - 0.0015], 1)
    yaw = (torch.rand(n, generator=gen, device=dev) * 2 - 1) * 0.3
    z = torch.zeros_like(yaw)
    quat = torch.stack([z, z, torch.sin(yaw / 2), torch.cos(yaw / 2)], 1)
    push = torch.tensor([0.05, -0.02, 0.0], device=dev).expand(n, 3)
    fall = torch.tensor([0.0, 0.0, -0.5], device=dev).expand(n, 3)
    sel = lambda m, a, b: torch.where(m[:, None], a, b)
    on = rest | drop
    ph.box_pos = sel(on, pos + sel(drop, torch.tensor([0.0, 0.0, 0.012], device=dev).expand(n, 3),
                                   torch.zeros_like(pos)), ph.box_pos)
    ph.box_quat = sel(on, quat, ph.box_quat)
    ph.box_linvel = sel(rest, push, sel(drop, fall, ph.box_linvel))
    ph.box_angvel = sel(on, torch.zeros_like(ph.box_angvel), ph.box_angvel)
    return ph


def contact_counts(engine, ph, dr):
    """Envs with cube-cube contact and with the platform on the ground (the
    plain engine's narrowphase on this state)."""
    import torch

    p = engine.params
    box = (ph.box_pos, ph.box_quat, ph.box_linvel, ph.box_angvel)
    box2 = (ph.box2_pos, ph.box2_quat, ph.box2_linvel, ph.box2_angvel)
    bm, bi = p.box_mass * dr.box_mass_scale, engine.box_inertia * dr.box_mass_scale
    b2m, b2i = p.box2_mass * dr.box_mass_scale, engine.box2_inertia * dr.box_mass_scale
    mu = torch.ones_like(bm)[:, None]  # per env, over the corners
    fa, _, _, _ = engine._box_box(box, box2, p.box_size / 2.0, bm, bi, p.box2_size / 2.0, b2m,
                                  b2i, mu)
    g_kick = torch.tensor([0.0, 0.0, p.gravity * engine.substep_dt], device=bm.device)
    fg, _ = engine._box_ground(box2, p.box2_size / 2.0, b2m, b2i, mu, g_kick)
    nz = lambda f: int((f.abs().sum(1) > 0).sum())
    return nz(fa), nz(fg)


def _scene_runs(scene, dev):
    """(k1(), k2(), task env) of a scene at N_ENVS envs: k1 builds the fused
    step on the K1 library loaded as the scene's K1 build and returns a
    function that launches it on the scene's rows (restored first: K1 writes
    them in place), k2 launches the K2 library loaded as the scene's K2
    build; both return their outputs. The state is made with the K1 library
    loaded now."""
    import torch

    from dexrobot_isaac_tpu_torch.envs import fused_step as fsm
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.physics import lane_step
    from dexrobot_isaac_tpu_torch.physics.types import box_rows
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    task, _, _ = SCENES[scene]
    env = make_env(load_config([f"task={task}", f"numEnvs={N_ENVS}"]), seed=7, device=dev)
    c = env.comps
    gen = torch.Generator(device=dev).manual_seed(1)
    fused0 = fsm.build_fused_step(env)
    fs, _ = fused0.reset()
    for _ in range(3):
        acts = torch.rand(N_ENVS, env.num_actions, generator=gen, device=dev) * 2 - 1
        fs, *_ = fused0.step_fn(fs, acts)
    st = fused0.unpack(fs)
    if c.engine.params.has_box2:
        st = dataclasses.replace(st, physics=stacked_scene(env, st, gen))
        fs = fused0.pack(st)
        n_cube, n_plat = contact_counts(c.engine, st.physics, st.dr)
        print(f"[scene] {task} at {N_ENVS} envs: {n_cube} with cube-cube contact, {n_plat} "
              "with the platform on the ground", flush=True)
    act_T = (torch.rand(N_ENVS, env.num_actions, generator=gen, device=dev) * 2 - 1).t().contiguous()
    reset, drs = env.draw_samples(N_ENVS, fs.difficulty)
    rst, drn = fused0.operand_rows(reset, drs, N_ENVS, dev)
    spw = env._spawn[:, None].expand(3, N_ENVS).contiguous()
    ph = st.physics
    T = lambda x: x.float().t().contiguous()
    rows = (T(ph.q), T(ph.qd), T(st.full_dof_targets), T(env._spawn.expand(N_ENVS, 3)),
            T(box_rows(ph, c.engine.params.has_box2)), st.dr.rows().contiguous())
    rf, ri = fs.rows_f.clone(), fs.rows_i.clone()

    def k1():
        fused = fsm.build_fused_step(env)

        def run():
            rf.copy_(fs.rows_f)
            ri.copy_(fs.rows_i)
            return [rf, ri, *fused.kernel(rf, ri, act_T, rst, drn, spw)]
        return run

    def k2():
        return lane_step.control_step_rows(c.engine, c.physics_steps_per_control, *rows)

    return k1, k2, env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=["grasp", "stacking", "both"], default="both")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--variants", default="", metavar="NAME,NAME,...")
    args = ap.parse_args(argv)
    wanted = set(filter(None, args.variants.split(",")))

    import torch

    if not torch.cuda.is_available():
        print("lane_probe: no CUDA card", file=sys.stderr)
        return 2
    from dexrobot_isaac_tpu_torch.utils import kernel_build as kb

    trees = dict(spec.split("=", 1) for spec in args.tree) or {"new": kb.CSRC}
    scenes = list(SCENES) if args.scene == "both" else [args.scene]
    root = os.path.join(kb.BUILD_DIR, "probe")
    shutil.rmtree(root, ignore_errors=True)
    jobs, phases = {}, {}
    for tree, csrc in trees.items():
        src, variants, items = _variants(csrc)
        for name, edits in variants.items():
            d = os.path.join(root, tree, name)
            os.makedirs(d)
            for f, text in src.items():
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(edits.get(f, text))
        for scene in scenes:
            _, k1b, k2b = SCENES[scene]
            phases[tree, scene] = build_phases(items, kb.BUILDS[k2b][1])
            todo = [("full", k1b), ("full", k2b), ("none", k2b)]
            todo += [("only_" + p, k2b) for p in phases[tree, scene]]
            if scene == "grasp":
                todo += [("model_shared", k1b), ("model_shared", k2b)]
            for name, build in (t for t in todo if not wanted or t[0] in wanted):
                src_f, defines = kb.BUILDS[build]
                d = os.path.join(root, tree, name)
                jobs[tree, name, build] = (os.path.join(d, src_f + ".cu"),
                                           os.path.join(d, build + ".so"), defines)
    libs = {}
    for key, (secs, log) in kb.nvcc(jobs).items():
        print(f"[build] {' '.join(key)}: {secs:.0f} s; " + " | ".join(kb.ptxas_lines(log)[-2:]),
              flush=True)
        libs[key] = jobs[key][1]
    card = kb.card()
    print(f"card: {card}", flush=True)

    dev = torch.device("cuda")
    first = next(iter(trees))
    report = {"card": card, "ms": {}, "phases": {}}

    def use(build, so, engine=None):
        """The library `so` as `build` for the wrappers (kernel_build's
        cache), the engine's model buffer made anew from it."""
        kb._libs.clear()
        kb._libs[build] = cdll = ctypes.CDLL(so)
        if engine is not None:
            engine.__dict__.pop("_lane_buffers", None)
        return cdll

    for scene in scenes:
        _, k1b, k2b = SCENES[scene]
        use(k1b, libs[first, "full", k1b])
        k1, k2, env = _scene_runs(scene, dev)
        ref = {}
        for (tree, name, build), so in libs.items():
            if build not in (k1b, k2b):
                continue
            cdll = use(build, so, env.comps.engine)
            fn = k1() if build == k1b else k2
            out = [x.clone() for x in fn()]
            torch.cuda.synchronize()
            near = ""
            if name in ("full", "model_shared"):
                want = ref.setdefault(build, out)
                same = all(torch.equal(a, b) for a, b in zip(want, out))
                rel = max(float((a.double() - b.double()).abs().max()
                                / b.double().abs().max().clamp_min(1e-6))
                          for a, b in zip(out, want))
                near = f", bits equal to {first} full: {same}, relative {rel:.2e}"
            ms = kb.device_ms(fn, 10)
            v = [ctypes.c_int() for _ in range(4)]
            if build == k1b:
                cdll.fused_step_occupancy(ctypes.byref(v[0]), ctypes.byref(v[1]))
            else:
                cdll.control_step_occupancy(*(ctypes.byref(x) for x in v))
            report["ms"][f"{tree} {scene} {build} {name}"] = ms
            print(f"[time] {tree} {scene} {build} {name}: {ms:.4f} ms/launch, {v[1].value} "
                  f"blocks/SM{near} ({card})", flush=True)
        kb._libs.clear()
        for tree in trees if not wanted else ():
            ms = lambda name: report["ms"][f"{tree} {scene} {k2b} {name}"]
            own = {p: ms("only_" + p) - ms("none") for p in phases[tree, scene]}
            total = sum(own.values())
            report["phases"][f"{tree} {scene}"] = own
            print(f"[phases] {tree} {scene} {k2b}: " + ", ".join(
                f"{p} {100 * t / total:.1f}%" for p, t in own.items())
                + f"; their sum {total:.4f} ms against full less none "
                f"{ms('full') - ms('none'):.4f} ms ({card})", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

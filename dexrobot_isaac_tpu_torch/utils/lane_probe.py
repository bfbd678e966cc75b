"""Where the lane kernels' time goes, on the card: variants of K1/K2 timed.

    python -m dexrobot_isaac_tpu_torch.utils.lane_probe

Needs one CUDA card and nvcc. Builds, next to the port's own build, variants
of csrc/ with one source edit each (nothing in csrc/ changes), one nvcc per
variant, all at once (`kernel_build.nvcc`), then times each at 4096
BlindGrasping envs from a contact-rich state (three fused steps of random
actions):

- `full`: the sources as they are (K1 and K2), the reference;
- `only_<phase>`: K2 with its substep cut to that one phase (of
  lp_substep in lane_physics.cuh) and the final FK and I/O kept; `none`
  keeps no phase. A variant's time less `none`'s is that phase's share of a
  control step (16 substeps); its outputs are not meaningful;
- `model_shared`: K1 and K2 with the LaneModel copied into each block's
  shared memory first, against `full`'s read-only global path.

Prints ptxas's registers and spills and, per variant, ms per launch (device
time of 10 launches after one, `kernel_build.device_ms`), resident blocks
per SM, and whether the outputs equal `full`'s bit for bit (for
`model_shared`).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import sys

PHASES = ["fk", "spheres", "forces", "body", "tree_store", "tree_level", "mass_row", "rhs",
          "ltl", "forward"]
N_ENVS = 4096

# the model_shared edit: after the env slots, each block copies the model
# into its dynamic shared memory and reads it from there
_COPY = """  LaneModel* msh = (LaneModel*)(lp_smem + LP_ENVS * {stride});
  for (int k = tid; k < (int)(sizeof(LaneModel) / 4); k += nthr)
    ((int*)msh)[k] = ((const int*)m)[k];
  __syncthreads();
  m = msh;
"""


def _variants(csrc: str):
    """{name: {file: text}} of the edited sources."""
    src = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)}
    lp = src["lane_physics.cuh"]
    a = lp.index("{", lp.index("LP_DEV void lp_substep(")) + 1
    b = lp.index("\n}\n", a)
    stmts = [s.strip() for s in re.split(r"\n(?=  (?:for|LP_WARP))", lp[a:b]) if s.strip()]
    if len(stmts) != len(PHASES):
        raise RuntimeError(f"lp_substep has {len(stmts)} phases, expected {len(PHASES)}")
    out = {"full": {}, "none": {"lane_physics.cuh": lp[:a] + "\n" + lp[b:]}}
    for name, st in zip(PHASES, stmts):
        out["only_" + name] = {"lane_physics.cuh": lp[:a] + "\n  " + st + "\n" + lp[b:]}
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
    return src, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lane_probe: no CUDA card", file=sys.stderr)
        return 2
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.physics import lane_step
    from dexrobot_isaac_tpu_torch.utils import kernel_build as kb
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    root = os.path.join(kb.BUILD_DIR, "probe")
    shutil.rmtree(root, ignore_errors=True)
    src, variants = _variants(kb.CSRC)
    jobs = {}
    for name, edits in variants.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        for f, text in src.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(edits.get(f, text))
        for lib in ("control_step", "fused_step"):
            if name in ("full", "model_shared") or lib == "control_step":
                jobs[(name, lib)] = (os.path.join(d, lib + ".cu"), os.path.join(d, lib + ".so"))
    libs = {}
    for key, (secs, log) in kb.nvcc(jobs).items():
        print(f"[build] {key[0]} {key[1]}: {secs:.0f} s; " + " | ".join(kb.ptxas_lines(log)[-2:]),
              flush=True)
        libs[key] = jobs[key][1]
    card = kb.card()
    print(f"card: {card}", flush=True)

    dev = torch.device("cuda")
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={N_ENVS}"]), seed=7, device=dev)
    c = env.comps
    fused = env.make_fused()
    fs, _ = fused.reset()
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        acts = torch.rand(N_ENVS, env.num_actions, generator=gen, device=dev) * 2 - 1
        fs, *_ = fused.step_fn(fs, acts)
    act_T = (torch.rand(N_ENVS, env.num_actions, generator=gen, device=dev) * 2 - 1).t().contiguous()
    reset, drs = env.draw_samples(N_ENVS, fs.difficulty)
    rst, drn = fused.operand_rows(reset, drs, N_ENVS, dev)
    spw = env._spawn[:, None].expand(3, N_ENVS).contiguous()
    st = fused.unpack(fs)
    ph = st.physics
    T = lambda x: x.float().t().contiguous()
    box = torch.cat([ph.box_pos, ph.box_quat, ph.box_linvel, ph.box_angvel], 1)
    rows = (T(ph.q), T(ph.qd), T(st.full_dof_targets), T(env._spawn.expand(N_ENVS, 3)), T(box),
            st.dr.rows().contiguous())
    rf, ri = fs.rows_f.clone(), fs.rows_i.clone()

    def k1():
        rf.copy_(fs.rows_f)
        ri.copy_(fs.rows_i)
        return [rf, ri, *fused.kernel(rf, ri, act_T, rst, drn, spw)]

    def k2():
        return lane_step.control_step_rows(c.engine, c.physics_steps_per_control, *rows)

    ref = {}
    for (name, lib), so in sorted(libs.items(), key=lambda kv: (kv[0][0] != "full", kv[0])):
        cdll = ctypes.CDLL(so)
        kb._libs.clear()
        kb._libs[lib] = cdll
        c.engine.__dict__.pop("_lane_buffers", None)
        fn = k1 if lib == "fused_step" else k2
        out = [x.clone() for x in fn()]
        torch.cuda.synchronize()
        same = None
        if name in ("full", "model_shared"):
            same = all(torch.equal(a, b) for a, b in zip(ref.setdefault(lib, out), out))
        ms = kb.device_ms(fn, 10)
        v = [ctypes.c_int() for _ in range(4)]
        if lib == "fused_step":
            cdll.fused_step_occupancy(ctypes.byref(v[0]), ctypes.byref(v[1]))
        else:
            cdll.control_step_occupancy(*(ctypes.byref(x) for x in v))
        print(f"[time] {lib} {name}: {ms:.4f} ms/launch, {v[1].value} blocks/SM, "
              f"bits equal to full: {same} ({card})", flush=True)
    kb._libs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())

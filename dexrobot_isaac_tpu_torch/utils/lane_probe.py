"""Where the lane kernels' time goes, on the card: variants of K1/K2 timed.

    python -m dexrobot_isaac_tpu_torch.utils.lane_probe

Needs one CUDA card and nvcc. Builds, next to the port's own build, variants
of csrc/ with one source edit each (nothing in csrc/ changes), one nvcc per
variant, eight at a time, then times each at 4096 BlindGrasping envs from a
contact-rich state (three fused steps of random actions):

- `full`: the sources as they are (K1 and K2), the reference;
- `only_<phase>`: K2 with its substep cut to that one phase (of
  lp_substep in lane_physics.cuh) and the final FK and I/O kept; `none`
  keeps no phase. A variant's time less `none`'s is that phase's share of a
  control step (16 substeps); its outputs are not meaningful;
- `model_shared`: K1 and K2 with the LaneModel copied into each block's
  shared memory first, against `full`'s read-only global path.

Prints ptxas's registers and spills and, per variant, ms per launch (CUDA
events over 10 launches after one), resident blocks per SM, and whether the
outputs equal `full`'s bit for bit (for `model_shared`).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

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
    jobs = []
    for name, edits in variants.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        for f, text in src.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(edits.get(f, text))
        for lib in ("control_step", "fused_step"):
            if name in ("full", "model_shared") or lib == "control_step":
                jobs.append((name, lib, d))
    t0, running, libs = time.perf_counter(), [], {}

    def reap(block):
        for job in list(running):
            p, key, so = job
            if block or p.poll() is not None:
                log, _ = p.communicate()
                running.remove(job)
                info = [ln.strip() for ln in log.splitlines()
                        if p.returncode or "registers" in ln or "spill" in ln]
                print(f"[build] {key[0]} {key[1]}: rc {p.returncode} "
                      f"{time.perf_counter() - t0:.0f} s; " + " | ".join(info[-2:]), flush=True)
                if p.returncode == 0:
                    libs[key] = so

    for name, lib, d in jobs:
        while len(running) >= 8:
            reap(False)
            time.sleep(0.2)
        so = os.path.join(d, lib + ".so")
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", so, os.path.join(d, lib + ".cu")]
        running.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), (name, lib), so))
    while running:
        reap(True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
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

    def cuda_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

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
        ms = cuda_ms(fn)
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

"""The fused step K1's roofline on the H100 (the port of `tools/roofline.py`):
which of the card's limits bounds env throughput?

    python -m dexrobot_isaac_tpu_torch.tools.roofline [num_envs] [env_steps_per_s] [device=cpu]

It accounts one BlindGrasping control step of K1 (`csrc/fused_step.cu`) at
`num_envs` envs (default 4096) against the card's limits:

  1. HBM bandwidth: the bytes K1 moves per env step, each operand read once
     and each output written once in the port's own layout (the packed
     f32 and i32 state rows in and out, the actions, reset, DR and spawn
     rows in; the cold rows, observations, reward, masks and reward
     components out), over 3.35 TB/s.
  2. f32 operations over 67 TFLOP/s, two ways: the semantic FLOPs of the
     plain step (`tools/count_flops.py`, every substep counted) and K1's own
     count of its f32 operations (`envs/fused_step.py` `fused_step_flops`,
     from the config records it runs with; K1 solves the hand's dynamics
     with a sparse LTL factor, so it does less than the plain step's dense
     Cholesky). K1's count leaves out the spawn projection of the envs that
     reset, a few in a thousand per step.
  3. Latency: each SM holds 32 envs (a half-warp per env, PR 3's design),
     so 132 SMs run 4,224 envs per wave; the time per control step per wave
     and per substep is set against the f32 work of one substep of a wave.

The rate is `env_steps_per_s`, else a fresh window of the fused path
(`bench.py`'s timing, 48 steps). This module also holds the H100's peaks and
the byte and operation bound that `chip_smoke.py` holds each kernel to.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

from dexrobot_isaac_tpu_torch.utils.device import card_name, resolve_device, split_device

# H100 SXM peaks, from NVIDIA's H100 Tensor Core GPU data sheet
H100_BYTES_PER_S = 3.35e12         # HBM3
H100_F32_PER_S = 67e12             # f32 outside the tensor cores
H100_BF16_DENSE_PER_S = 989.4e12   # BF16 tensor cores, dense
H100_SMS = 132
ENVS_PER_SM = 32                   # K1's one-box builds: 4 blocks of 8 envs


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move `nbytes` and do `flops` f32 operations, whichever is larger."""
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bytes(env, fused, n: int) -> Dict[str, int]:
    """K1's bytes at `n` envs: {"in", "out"} (the state rows both ways)."""
    lay = fused.layout
    f32_in = lay.rows_f + env.num_actions + fused.rst_rows + 4 + 3
    f32_out = lay.rows_f + lay.rows_c + fused.obs_dim + 1 + len(fused.comp_names)
    i32 = lay.rows_i
    return {"in": 4 * n * (f32_in + i32), "out": 4 * n * (f32_out + i32 + 4)}


def k1_flops(env, fused, n: int, lib) -> int:
    """K1's own f32 operations of one launch at `n` envs with none
    resetting (`fused_step_flops` on the records built against `lib`)."""
    from dexrobot_isaac_tpu_torch.envs import fused_step
    from dexrobot_isaac_tpu_torch.physics import lane_step

    c = env.comps
    model = lane_step.lane_model_array(c.engine, c.physics_steps_per_control, lib)
    cfg = fused_step.fused_config_array(env, fused.layout, fused.comp_names, fused.rst_rows,
                                        lib)
    return fused_step.fused_step_flops(cfg, model, n, 0, fused.build)


def run(n: int = 4096, steps_per_s: Optional[float] = None, device="cuda",
        flops_per_env_step: Optional[float] = None) -> Dict:
    """Prints the roofline and returns its numbers. K1's own count reads its
    records' layout from the task's nvcc build on the card, and on the CPU
    from a g++ build of the same source (`kernel_build.host_library`).
    `flops_per_env_step` is the semantic count where the caller has it (the
    bench's line), else counted here."""
    from dexrobot_isaac_tpu_torch import bench
    from dexrobot_isaac_tpu_torch.factory import make_env
    from dexrobot_isaac_tpu_torch.tools import count_flops
    from dexrobot_isaac_tpu_torch.utils import kernel_build as kb
    from dexrobot_isaac_tpu_torch.utils.config import load_config

    dev = resolve_device(device)
    env = make_env(load_config(["task=BlindGrasping", f"numEnvs={n}"]), seed=0, device=dev)
    fused = env.make_fused()
    lib = kb.load(fused.build) if dev.type == "cuda" else kb.host_library(fused.build)
    card = card_name(dev)
    if steps_per_s is None:
        steps_per_s = bench.run(n, 48, dev, path="fused", quiet=True)["per_path"]["fused"]
    b = k1_bytes(env, fused, n)
    per_env_bytes = (b["in"] + b["out"]) / n
    semantic = flops_per_env_step or count_flops.count("BlindGrasping", 8)["flops_per_env_step"]
    own = k1_flops(env, fused, n, lib) / n
    c = env.comps
    n_sub = c.engine.params.substeps * c.physics_steps_per_control
    wave = H100_SMS * ENVS_PER_SM
    waves = -(-n // wave)
    ctrl_s = n / steps_per_s
    bw = per_env_bytes * steps_per_s
    out = {
        "num_envs": n, "env_steps_per_s": steps_per_s, "bytes_per_env_step": per_env_bytes,
        "bytes_in_per_env_step": b["in"] / n, "bytes_out_per_env_step": b["out"] / n,
        "flops_per_env_step": semantic, "k1_flops_per_env_step": own,
        "hbm_share": bw / H100_BYTES_PER_S, "f32_share": semantic * steps_per_s / H100_F32_PER_S,
        "k1_f32_share": own * steps_per_s / H100_F32_PER_S, "waves": waves,
        "us_per_control_step": ctrl_s * 1e6,
        "us_per_substep_per_wave": ctrl_s * 1e6 / waves / n_sub,
    }
    # one substep of one wave with every f32 lane of the card busy
    per_wave = min(n, wave)
    min_us = {k: f / n_sub * per_wave / H100_F32_PER_S * 1e6
              for k, f in (("semantic", semantic), ("k1", own))}
    lay = fused.layout
    print(f"fused kernel rows: f32 {lay.rows_f} + i32 {lay.rows_i} in/out, cold {lay.rows_c} "
          f"out-only; obs/extras outputs included in bytes below")
    print(f"bytes/env-step: {per_env_bytes:,.0f} (in {b['in'] / n:,.0f} + out "
          f"{b['out'] / n:,.0f})")
    print(f"measured: {steps_per_s:,.0f} env-steps/s at {n} envs on {card} ({waves} wave(s) of "
          f"{wave} resident envs: {H100_SMS} SMs x {ENVS_PER_SM})")
    print(f"  HBM:  {bw / 1e9:7.1f} GB/s   = {100 * out['hbm_share']:5.2f}% of "
          f"{H100_BYTES_PER_S / 1e9:,.0f} GB/s peak")
    print(f"  f32:  {semantic * steps_per_s / 1e12:7.2f} TFLOP/s = {100 * out['f32_share']:5.2f}% "
          f"of {H100_F32_PER_S / 1e12:.0f} TFLOP/s peak (semantic {semantic:,.0f} FLOPs/env-step);"
          f" K1's own count {own:,.0f}: {100 * out['k1_f32_share']:5.2f}%")
    print(f"  time: {ctrl_s * 1e6:,.0f} us/control-step -> {ctrl_s * 1e6 / waves:,.0f} us/wave -> "
          f"{out['us_per_substep_per_wave']:,.2f} us/substep/wave ({n_sub} sequential substeps)")
    print(f"  substep f32 work of a wave at peak: {min_us['semantic']:.3f} us (semantic), "
          f"{min_us['k1']:.3f} us (K1's own) -> latency/issue overhead "
          f"{out['us_per_substep_per_wave'] / max(min_us['k1'], 1e-12):,.1f}x over K1's own")
    return out


def main(argv=None) -> int:
    pos, device = split_device(list(sys.argv[1:] if argv is None else argv))
    run(int(pos[0]) if pos else 4096, float(pos[1]) if len(pos) > 1 else None, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

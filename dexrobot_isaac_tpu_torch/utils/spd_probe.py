"""K3 (`csrc/spd_solve.cu`) against other builds of its source, on the card.

    python -m dexrobot_isaac_tpu_torch.utils.spd_probe [--other NAME=PATH]
        [--rounds R] [--sizes N,N,...] [--sass DIR]

Needs one CUDA card and nvcc. Builds the port's source (`new`) and each
other source given (`--other old=_trees/parent/dexrobot_isaac_tpu_torch/csrc/spd_solve.cu`,
a parent commit unpacked with `git archive`, or an edited copy of the
source), all at once (`kernel_build.nvcc`); prints each build's ptxas lines
(registers, spills, stack) and, where the library exports
`spd_solve_occupancy`, its shared bytes per block and resident systems per
SM, and the count of each SASS opcode in `spd_solve_kernel` (`cuobjdump
-sass`; the listing goes to DIR with `--sass`). Every build has the same C
interface (`spd_solve_launch`).

Then, on 4096 seeded random SPD systems (26x26 float32) and twelve copies
of them (the sectors of their lower triangles hold 99 MB, twice the H100's
50 MB L2), for each build: the relative
error against the plain version and against a float64 solve, whether two
launches give the same bits, and ms per launch warm (the same inputs back to
back, so they stay in L2, as the Coriolis step leaves them) and cold
(rotating over the copies), device time by CUDA events with the launches
queued (`kernel_build.device_ms`). Builds are timed in turns, their order
reversed in every other round (A B, B A, ...). With `--sizes`, each build
is also timed warm on the first N of the systems (132: one warp on each of
the 132 SMs, the time of one system's dependent chain; 1056, 2112: 8 and 16
warps on each SM). A one-element fill, a launch that does no work, is timed
the same way. The last line is a JSON
object of the numbers; the exit code is 1 when a build is off the plain
version by more than 1e-5 relative or gives other bits on a second launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

N_SYS = 4096
COPIES = 12  # the lower triangles' sectors of 12 copies: 99 MB, twice the L2


def _sass_counts(so: str, kb, sass_dir):
    """{opcode: count} of spd_solve_kernel's SASS in the library `so`."""
    tool = os.path.join(os.path.dirname(kb._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120).stdout
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, os.path.basename(so)[:-3] + ".sass"), "w") as f:
            f.write(text)
    counts = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", text):
        op = m.group(2).split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sizes", default="", metavar="N,N,...")
    ap.add_argument("--sass", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    sizes = [int(n) for n in args.sizes.split(",") if n]
    if any(not 1 <= n <= N_SYS for n in sizes):
        ap.error(f"--sizes takes system counts from 1 to {N_SYS}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("spd_probe: no CUDA card", file=sys.stderr)
        return 2
    from dexrobot_isaac_tpu_torch.ops import linalg
    from dexrobot_isaac_tpu_torch.utils import kernel_build as kb

    sources = {"new": os.path.join(kb.CSRC, "spd_solve.cu")}
    sources.update(spec.split("=", 1) for spec in args.other)
    out_dir = os.path.join(kb.BUILD_DIR, "spd_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    sos = {name: os.path.join(out_dir, f"{name}.so") for name in sources}
    built = kb.nvcc({name: (os.path.abspath(src), sos[name]) for name, src in sources.items()})
    libs = {}
    for name, so in sos.items():
        for ln in kb.ptxas_lines(built[name][1]):
            print(f"[build] {name}: {ln}", flush=True)
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.spd_solve_launch.argtypes = [P, P, P, I, I, P]
        libs[name] = lib
        ops = _sass_counts(so, kb, args.sass)
        print(f"[sass] {name}: {sum(ops.values())} instructions; " + ", ".join(
            f"{k} {v}" for k, v in list(ops.items())[:16]), flush=True)
        if hasattr(lib, "spd_solve_occupancy"):
            v = [ctypes.c_int() for _ in range(3)]
            kb.check(lib.spd_solve_occupancy(*map(ctypes.byref, v)), f"{name} occupancy")
            print(f"[build] {name}: occupancy {v[0].value} B shared per block of {v[2].value} "
                  f"systems, {v[1].value} blocks = {v[1].value * v[2].value} systems resident "
                  "per SM", flush=True)
    card = kb.card()
    print(f"card: {card}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    r = rng.normal(size=(N_SYS, 26, 26))
    a = r @ r.transpose(0, 2, 1) / 26 + np.eye(26) * rng.uniform(0.01, 1.0, (N_SYS, 1, 26))
    A = torch.as_tensor(a.astype(np.float32), device=dev)
    b = torch.as_tensor(rng.normal(size=(N_SYS, 26)).astype(np.float32), device=dev)
    cold = [(A.clone(), b.clone()) for _ in range(COPIES)]
    x_plain = linalg.spd_solve_plain(A, b)
    x_64 = torch.linalg.solve(A.double(), b.double()[..., None])[..., 0]
    rel = lambda u, w: float((u.double() - w.double()).abs().max() / w.double().abs().max())
    stream = kb.stream_ptr(dev)

    def launch(lib, A, b):
        x = torch.empty_like(b)
        kb.check(lib.spd_solve_launch(A.data_ptr(), b.data_ptr(), x.data_ptr(), A.shape[0], 26,
                                      stream), "spd_solve")
        return x

    res = {}
    for name, lib in libs.items():
        x1, x2 = launch(lib, A, b), launch(lib, A, b)
        torch.cuda.synchronize()
        res[name] = {"err_plain": rel(x1, x_plain), "err_f64": rel(x1, x_64),
                     "same_bits": bool(torch.equal(x1, x2)), "warm_ms": [], "cold_ms": []}
        print(f"[check] {name}: relative err vs plain {res[name]['err_plain']:.2e}, vs float64 "
              f"{res[name]['err_f64']:.2e} (plain vs float64 {rel(x_plain, x_64):.2e}); two "
              f"launches bitwise equal: {res[name]['same_bits']}", flush=True)
    order = list(libs)
    for rnd in range(args.rounds):
        for name in order if rnd % 2 == 0 else order[::-1]:
            lib, k = libs[name], [0]

            def rotate():
                A_, b_ = cold[k[0] % COPIES]
                k[0] += 1
                launch(lib, A_, b_)

            res[name]["warm_ms"].append(kb.device_ms(lambda: launch(lib, A, b), 200))
            res[name]["cold_ms"].append(kb.device_ms(rotate, 10 * COPIES))
            for n in sizes:
                A1, b1 = A[:n], b[:n]
                res[name].setdefault(f"warm_ms_{n}", []).append(
                    kb.device_ms(lambda: launch(lib, A1, b1), 200))
    bound_ms = linalg.spd_solve_bytes(26) * N_SYS / 3.35e12 * 1e3  # HBM3, H100 SXM data sheet
    tiny = torch.zeros(1, device=dev)
    fill_ms = kb.device_ms(tiny.zero_, 200)
    print(f"[time] one-element fill (a launch that does no work): {fill_ms:.5f} ms", flush=True)
    fmt = lambda ts: ", ".join(f"{t:.5f}" for t in ts)
    for name, v in res.items():
        lat = "".join(f", {n} systems {fmt(v[f'warm_ms_{n}'])}" for n in sizes)
        print(f"[time] {name}: warm {fmt(v['warm_ms'])} ms/launch, cold {fmt(v['cold_ms'])} "
              f"ms/launch{lat}; byte bound {bound_ms:.5f} ms ({card})", flush=True)
    print(json.dumps({"card": card, "n_sys": N_SYS, "bound_ms": bound_ms, "fill_ms": fill_ms,
                      "builds": res}))
    return int(any(v["err_plain"] > 1e-5 or not v["same_bits"] for v in res.values()))


if __name__ == "__main__":
    sys.exit(main())

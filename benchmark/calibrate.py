"""Readings for the limits of `correct`: runs a cell on several seeds in one
process, each as `benchmark.run` does, and prints per seed one JSON line
with the port's compared numbers ("checks") and the control's (the
reference in the port's place in the next precision down: bfloat16 for
the env step, TF32 for the learner's matmuls).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --seconds 5 [--fault NAME]

`--fault` plants one of `benchmark/faults.py`'s faults under the timed
path: its "checks" are then the fault's readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    args = ap.parse_args(argv)
    spec = run.cell_spec(args.workload)
    run.steady_host()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = run.run_cell(args.workload, seed, args.seconds, False, "cuda", spec,
                            control=not args.no_control, t0=t0,
                            fault=faults.FAULTS[args.fault]() if args.fault else None)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "checks": {k: v["value"] for k, v in line["checks"].items()},
                          "control": line.get("control"),
                          "diagnostics": line.get("diagnostics"), "metrics": line["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

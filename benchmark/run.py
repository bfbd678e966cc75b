"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json. Its configuration
(`benchmark/configs/<config>.json`: the port's config overrides and the
frozen work counts), its traffic mix (`benchmark/traffic/<traffic>.json`:
the parameters of one of the loops in `benchmark/loops/`), its limits
(`benchmark/limits/<cell>.json`) and each per-layer metric's reader
(`benchmark/metrics/<metric>.py`) are found by name. With `--trace 0` the
line holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from the same run with the harness's spans and an in-memory
profile of a stretch after the window. The port's outputs are checked
against the plain reference in `benchmark/reference/` once the window has
closed; each compared number and its limit end the line and stderr.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dexrobot_isaac_tpu")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the whole name: the port's own name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_spec(workload: str) -> SimpleNamespace:
    """Everything BENCHMARK.json and the cell's files say about `workload`."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    reports = lambda m: "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if ("workloads" in m and workload in m["workloads"])
             or ("workloads" not in m and m["moves"] in e2e_names)]
    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), config=load_json(HERE, "configs", w["config"] + ".json"),
        traffic=load_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=load_json(HERE, "limits", workload + ".json"), end_to_end=e2e, per_layer=layer)


def quantity(metric: str) -> str:
    """What a loop measures under an end-to-end metric's name: the name up
    to its first dot. A suffix names a metric of some cells only, so that
    they can have a bound of their own (`env_steps_per_s.two_box`)."""
    return metric.split(".")[0]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(dev, chips: int) -> Dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             spec: Optional[SimpleNamespace] = None, control: bool = False,
             t0: Optional[float] = None, fault=None) -> Dict:
    """One run of a cell: set-up, the window, the traced stretch when
    `trace`, then the comparison with the reference. Returns the result
    line's dict; with `control`, also the control's numbers under
    "control". `spec` replaces the cell's files (the tests shrink it);
    `fault` is handed to the loop (the tests break the timed path)."""
    import torch

    spec = spec or cell_spec(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    os.environ.setdefault("DEXHAND_RUNS_DIR", os.path.join(tempfile.gettempdir(),
                                                           "dexhand_bench_runs"))
    loop = importlib.import_module(f"benchmark.loops.{spec.traffic['loop']}")
    ctx = SimpleNamespace(spec=spec, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                          device=dev, t0=_T0 if t0 is None else t0, fault=fault)
    rec = loop.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    device = device_info(dev, spec.chips)
    rec.release()  # the port's state: the reference runs after the peak is read
    numbers = rec.judge(control=False)
    checks = {k: {"value": v, "limit": spec.limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        device.update(busy_s=rec.device_trace.busy_s, window_s=rec.device_trace.window_s)
        metrics = {}
        for m in spec.per_layer:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec.end_to_end[quantity(m["name"])], "unit": m["unit"]}
                   for m in spec.end_to_end}
    line = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": rec.device_trace.top_ops(),
                             "idle_gaps": rec.device_trace.top_gaps()}
    line["checks"] = checks
    if control:
        line["control"] = rec.judge(control=True)
        if rec.diagnose is not None:
            line["diagnostics"] = rec.diagnose()
    return line


def steady_host() -> None:
    """One process on one core with one intra-op thread: the cells are
    bound by the host's launch path, and a pinned process drifts less from
    run to run (PERF.md). The core is the second of the process's own
    affinity mask (the first where it has one), the steadiest of the
    choices measured; a mask that the caller narrows is kept to."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[1] if len(cores) > 1 else cores[0]})
    import torch

    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    spec = cell_spec(args.workload)
    steady_host()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", spec)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's GPUs. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, then ``checks``); the last lines of standard error are the
numbers compared, each beside its limit.

``--device cpu --dry`` rehearses a run here without a GPU: one round at
a small image size through the same files and calls, the program's
outputs still judged against the reference. It measures nothing, and its
line says so.

Exit codes: 0 a result was printed; 2 no usable GPU; 3 the program is not
in this checkout; 4 JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRY_REQUESTS = 2


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def dry_config(config: dict) -> dict:
    """The configuration at the smallest square input of at least 32 that
    every layer of it maps to one row or more."""
    from perfbench import work

    for size in range(32, 1024):
        small = dict(config, in_h=size, in_w=size)
        try:
            if all(layer.out_h >= 1 for layer in work.layers(small)):
                return small
        except ValueError:
            continue
    raise ValueError(f"{config['name']}: no input size works")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi gave nothing)"


def number(x):
    return x if x is None or math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dry", action="store_true",
                    help="with --device cpu: rehearse one round, measure "
                         "nothing")
    args = ap.parse_args(argv)
    if (args.device == "cpu") != args.dry:
        ap.error("--device cpu goes with --dry, and only with it")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import bench, program, spec

    table = spec.load()
    cell = spec.cell(table, args.workload)
    import torch

    if args.dry:
        torch.set_num_threads(1)
        cell.config = dry_config(cell.config)
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"run: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  f" visible. The benchmark measures on the GPU only.",
                  file=sys.stderr)
            return 2
        torch.set_num_threads(bench.HOST_THREADS)
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    try:
        run = bench.run_cell(cell, args.seed, args.seconds,
                             trace=bool(args.trace), device=device,
                             t_start=T_START,
                             max_requests=DRY_REQUESTS if args.dry else None)
    except program.ProgramMissing as e:
        print(f"run: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"run: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4

    metrics = {}
    for m in spec.metrics_for(table, cell.name, bool(args.trace)):
        if args.dry:
            metrics[m["name"]] = "not measured"
            continue
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.dry:
        dev = {"platform": "cpu", "kind": "cpu (dry rehearsal)", "count": 0,
               "memory_peak_bytes": "not measured"}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    err = sys.stderr
    if run.lateness_s:
        late = sorted(run.lateness_s)
        print(f"generator lateness: median "
              f"{late[len(late) // 2] * 1e3:.4f} ms, p95 "
              f"{late[int(0.95 * (len(late) - 1))] * 1e3:.4f} ms, max "
              f"{late[-1] * 1e3:.4f} ms over {len(late)} requests", file=err)
    if run.engine:
        print(f"engine: {run.engine}", file=err)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 run.setup_parts.items()), file=err)
    if not args.dry:
        print(f"peak {bench.work.PEAK_FLOPS / 1e12:.0f} TFLOP/s (3xTF32) "
              f"and {bench.work.PEAK_HBM_BYTES_PER_S / 1e12:.2f} TB/s on "
              f"{power_limit()}", file=err)
    if args.trace and run.trace is not None and not args.dry:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.slice_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    elif args.trace and not args.dry:
        print("run: the trace held no device event in the slice",
              file=err)
    result["checks"] = {k: {"value": number(v["value"]), "limit": v["limit"]}
                        for k, v in run.checks.items()}
    for k, v in run.checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read the two ends of a cell's ``correct`` limit on the chip, in one
process: for each seed, a short window of the cell's own traffic through
the program, its sampled answers against the fp32 reference (the lower
reading), and the control in the program's place on the same images (the
upper reading): the reference with every conv's operands rounded to TF32.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 3
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import bench, spec

    torch.set_num_threads(bench.HOST_THREADS)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    device = torch.device("cuda:0")
    lows, highs = [], []
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = bench.run_cell(cell, seed, args.seconds, trace=False,
                             device=device, t_start=bench.now(),
                             control=True)
        gap = run.checks["worst_rel_gap"]["value"]
        lows.append(gap)
        highs.append(run.control_gap)
        print(f"{args.workload} seed {seed}: program {gap!r}, control "
              f"{run.control_gap!r}, answers {len(run.answers)}, correct "
              f"{run.correct}, attempted {run.attempted}, failed "
              f"{run.failed}", flush=True)
    print(f"{args.workload}: lower reading (program, worst of "
          f"{len(lows)} seeds) {max(lows)!r}; upper reading (control, "
          f"least of {len(highs)}) {min(highs)!r}; ratio "
          f"{min(highs) / max(lows):.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark harness: one entry per paper table/figure + the measured
benchmarks + the roofline, the twin of ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV (derived = the headline number
the paper reports for that artifact), in the reference's order and under
its names. The measured entries (``occam_span_engine``, ``occam_stap``,
``occam_serve``, ``occam_async``, ``occam_calibrate``, ``occam_quant``)
run in-process on the device given (``cuda:0`` by default) and write
``results/BENCH_torch_<name>.json``; ``occam_autoplan`` plans on the
host. Then every ``BENCH_torch_*.json`` gets its audit stamp, and the
roofline rows follow when the port's dry-run records exist under
``results/torch_dryrun``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

from . import common, tables
from .occam_async import occam_async
from .occam_autoplan import occam_autoplan
from .occam_calibrate import occam_calibrate
from .occam_quant import occam_quant
from .occam_serve import occam_serve
from .occam_stap import occam_stap

# (name, fn, note, takes a device)
BENCHES = [
    ("table2_partitions", tables.table2_partitions,
     "total spans across 8 nets", False),
    ("table3_misses", tables.table3_misses,
     "mean normalized miss (paper ~0.05)", False),
    ("table4_traffic", tables.table4_traffic,
     "geomean traffic reduction (paper 21x)", False),
    ("fig7_capacity", tables.fig7_capacity,
     "mean filter fraction of capacity (paper: most)", False),
    ("fig8_speedup", tables.fig8_speedup,
     "geomean speedup vs base (paper 2.06x)", False),
    ("fig9_energy", tables.fig9_energy,
     "mean energy saving (paper 0.33)", False),
    ("cache_sensitivity", tables.cache_sensitivity,
     "traffic ratio 3MB/6MB (>1 per paper §V-B2)", False),
    ("occam_span_engine", tables.occam_span_engine,
     "compiled-engine speedup vs interpreted streaming (floor 10x)", True),
    ("stap_example", tables.stap_example,
     "sim/paper throughput ratio (1.0 = exact)", False),
    ("occam_stap", occam_stap,
     "STAP pipeline throughput measured/predicted (1.0 = exact)", True),
    ("occam_serve", occam_serve,
     "serving session throughput measured/predicted (1.0 = exact)", True),
    ("occam_async", occam_async,
     "async engine throughput measured/predicted (1.0 = exact)", True),
    ("occam_autoplan", occam_autoplan,
     "memoized DP-sweep speedup vs naive (frontier == exhaustive best)",
     False),
    ("occam_calibrate", occam_calibrate,
     "calibrated-over-analytic prediction-error improvement (>1 = helped)",
     True),
    ("occam_quant", occam_quant,
     "int8-over-fp32 off-chip byte reduction (>1 = quantization pays)",
     True),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the measured entries run (default: cuda:0)")
    dev = common.resolve_device(ap.parse_args(argv).device)
    derived = {}
    print("name,us_per_call,derived")
    for name, fn, _note, on_device in BENCHES:
        t0 = time.perf_counter()
        _rows, derived[name] = fn(device=dev) if on_device else fn()
        common.block(dev)
        us = (time.perf_counter() - t0) * 1e6
        print(f"{name},{us:.0f},{derived[name]:.4g}")

    # every results/BENCH_torch_*.json carries an audit stamp: the
    # measured benchmarks embed the verdict of the plan they measured;
    # documents from before the auditor get an explicit "unaudited"
    # marker rather than a silently absent key
    from .audit_stamp import backfill

    for path in backfill(str(common.RESULTS)):
        print(f"audit: stamped pre-audit artifact {path} as unaudited",
              file=sys.stderr)

    # roofline (from the port's dry-run records, when present): the cells
    # and the compute term only
    from . import roofline

    printed_reason = False
    for mesh in ("16x16", "2x16x16"):
        t0 = time.perf_counter()
        rows = roofline.load_rows(mesh=mesh)
        us = (time.perf_counter() - t0) * 1e6
        if not rows:
            continue
        mean_compute = sum(r["t_compute_s"] for r in rows) / len(rows)
        print(f"roofline_{mesh}_cells,{us:.0f},{len(rows)}")
        print(f"roofline_{mesh}_compute_s,{us:.0f},{mean_compute:.4g}")
        if not printed_reason:
            print("roofline: no fraction rows: "
                  f"{rows[0]['reasons']['roofline_fraction']} "
                  f"({rows[0]['reasons']['t_memory_s']}; "
                  f"{rows[0]['reasons']['t_collective_s']})",
                  file=sys.stderr)
            printed_reason = True
    return derived


if __name__ == "__main__":
    main()

"""Fleet-aware planning benchmark: the ``occam.autoplan`` frontier sweep
over the paper-network zoo; the twin of ``benchmarks/occam_autoplan.py``.

Two claims are measured, per net:

* **Optimality** — the frontier's best-traffic candidate equals the
  exhaustive best over (capacity x placement): every candidate capacity
  is re-planned naively with ``partition_cnn`` and, on nets small enough,
  the full PBS enumeration (``brute_force_partition``) cross-checks the
  DP itself.
* **Memoized-sweep economy** — ``core.partition.PartitionSweep`` (one
  footprint table, fits-set memo, bisection fill) vs naive per-capacity
  DP re-runs from scratch, same capacity set. The speedup is the
  headline number.

Pure planning on the host — no device. Its documents equal the
reference's apart from the host-clock seconds. Writes
``results/BENCH_torch_autoplan.json``:

    PYTHONPATH=src python -m repro_torch.benchmarks.occam_autoplan
"""
from __future__ import annotations

import time

from . import common

VMEM = 3 * 1024 * 1024          # the paper's 3 MB on-chip memory (INT8)
CHIPS = 16
# nets the benchmark sweeps (the zoo's heavyweights are excluded to keep
# the harness fast; the sweep math is identical)
SWEEP_NETS = ("alexnet", "zfnet", "vggnet", "resnet18", "resnet34")
# nets small enough for the exponential PBS enumeration cross-check
BRUTE_FORCE_MAX_LAYERS = 12


def _geomean(xs):
    import math

    xs = [max(x, 1e-12) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def measure_net(name: str, chips: int = CHIPS, vmem: int = VMEM) -> dict:
    """One net's frontier sweep + optimality and memoization checks."""
    from repro_torch import occam
    from repro_torch.core.partition import (CNNPartitionProblem,
                                            PartitionSweep,
                                            brute_force_partition,
                                            partition_cnn)
    from repro_torch.models.zoo import get_network

    from .audit_stamp import audit_verdict

    net = get_network(name)
    fleet = occam.Fleet(chips=chips, vmem_elems=vmem)

    t0 = time.perf_counter()
    frontier = occam.autoplan(net, fleet, objective="traffic")
    t_autoplan = time.perf_counter() - t0

    # memoized sweep vs naive per-capacity re-runs, same capacity set
    # (the capacity list falls out of the timed sweep itself)
    t0 = time.perf_counter()
    swept = PartitionSweep(net, 1).sweep(vmem)
    t_memo = time.perf_counter() - t0
    caps = [pt.capacity_elems for pt in swept]
    t0 = time.perf_counter()
    naive = {c: partition_cnn(net, c) for c in caps}
    t_naive = time.perf_counter() - t0

    # exhaustive best over capacities (the naive runs ARE the
    # enumeration); the frontier's best-traffic candidate must match
    exhaustive_best = min(r.transfers for r in naive.values())
    best = frontier.best("traffic")
    matches = best.traffic == exhaustive_best
    # the memoized sweep must agree point-for-point with naive
    sweep_exact = all(pt.result.transfers == naive[pt.capacity_elems]
                      .transfers for pt in swept)
    brute_match = None
    if net.n_layers <= BRUTE_FORCE_MAX_LAYERS:
        bf_cost, _cuts = brute_force_partition(
            CNNPartitionProblem(net, vmem, 1))
        brute_match = best.traffic == bf_cost

    b_thr = frontier.best("throughput")
    return {
        "audit": audit_verdict(frontier),
        "net": name,
        "n_layers": net.n_layers,
        "capacities": len(caps),
        "dp_runs": frontier.stats["dp_runs"],
        "partitions": frontier.stats["partitions"],
        "placements_scored": frontier.stats["placements_scored"],
        "pareto_size": len(frontier),
        "best_traffic": best.traffic,
        "exhaustive_best_traffic": exhaustive_best,
        "matches_exhaustive": bool(matches and sweep_exact),
        "matches_brute_force": brute_match,
        "best_throughput_replicas": list(b_thr.replicas),
        "best_throughput_chips": b_thr.chips,
        "autoplan_seconds": t_autoplan,
        "sweep_seconds": t_memo,
        "naive_seconds": t_naive,
        "sweep_speedup": t_naive / max(t_memo, 1e-9),
    }


def autoplan_measurement(nets=SWEEP_NETS, chips: int = CHIPS,
                         vmem: int = VMEM) -> dict:
    rows = [measure_net(n, chips, vmem) for n in nets]
    return {
        "audit": {
            "ok": all(r["audit"]["ok"] for r in rows),
            "rules": sorted({rule for r in rows
                             for rule in r["audit"]["rules"]}),
            "findings": sum(r["audit"]["findings"] for r in rows),
        },
        "fleet": {"chips": chips, "vmem_elems": vmem},
        "nets": rows,
        "all_match_exhaustive": all(r["matches_exhaustive"] for r in rows),
        "sweep_speedup_geomean": _geomean([r["sweep_speedup"]
                                           for r in rows]),
    }


def occam_autoplan():
    """Harness entry (``repro_torch.benchmarks.run``): run the sweep,
    persist the JSON, and report the memoized-sweep speedup (frontier
    must match the exhaustive best on every net)."""
    doc = autoplan_measurement()
    path = common.out_path("autoplan")
    common.write_doc(path, doc)
    if not doc["all_match_exhaustive"]:
        raise AssertionError(
            "autoplan best-traffic candidate diverged from the exhaustive "
            f"capacity enumeration; see {path}")
    return doc["nets"], doc["sweep_speedup_geomean"]


if __name__ == "__main__":
    rows, speedup = occam_autoplan()
    for r in rows:
        print(f"{r['net']:10s} caps={r['capacities']:4d} "
              f"dp_runs={r['dp_runs']:4d} pareto={r['pareto_size']:3d} "
              f"exhaustive_match={r['matches_exhaustive']} "
              f"speedup={r['sweep_speedup']:.1f}x")
    print(f"geomean memoized-sweep speedup: {speedup:.2f}x "
          f"(results -> {common.out_path('autoplan')})")

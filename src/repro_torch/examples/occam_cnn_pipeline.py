"""The paper, end to end on one CNN, the twin of
``examples/occam_cnn_pipeline.py``: describe the hardware as an
``occam.Fleet``, let ``occam.autoplan`` search ResNet-34's planning
frontier (capacity sweep x STAP placements), validate traffic, and watch
the frontier's best pick change as the fleet grows.

It plans and simulates only, as the reference: no device is touched,
so it takes no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.occam_cnn_pipeline
"""
from __future__ import annotations

import argparse

from repro_torch import occam
from repro_torch.core.partition import partition_report
from repro_torch.core.stap import simulate
from repro_torch.core.traffic import (MachineModel, base_traffic,
                                      compare_schemes, occam_traffic)
from repro_torch.models.zoo import get_network

CAP = 3 * 1024 * 1024


def main(argv=None) -> dict:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    net = get_network("resnet34")
    fleet = occam.Fleet(chips=16, vmem_elems=CAP)
    frontier = occam.autoplan(net, fleet, objective="throughput")
    plan = frontier.best("traffic").plan    # min-traffic candidate's plan
    part = plan.partition
    print(f"ResNet-34 under Fleet(chips=16, vmem=3MB): "
          f"{frontier.stats['capacities_swept']} capacities swept with "
          f"{frontier.stats['dp_runs']} DP runs, "
          f"{frontier.stats['placements_scored']} placements scored, "
          f"{len(frontier)} Pareto candidates")
    print(f"min-traffic candidate -> {plan.n_spans} spans "
          f"(paper Table II: 10 spans); routes "
          f"{sorted(set(r.route for r in plan.routes))}")
    rep = partition_report(net, CAP)
    for r in rep:
        print(f"  span({r['start']:3d},{r['end']:3d}) "
              f"tile_rows={r['occam_tile_rows']:3d} "
              f"closure={r['closure_elems']/1e3:7.1f}K "
              f"weights={r['weight_elems']/1e6:5.2f}M "
              + ("" if r["fits"]
                 else "(oversized single layer: lower bound)"))

    base = base_traffic(net)
    occ = occam_traffic(net, CAP, partition=part)
    print(f"\ntraffic: base {base.offchip_elems/1e6:.1f}M elems/image -> "
          f"occam {occ.offchip_elems/1e6:.2f}M  "
          f"({base.offchip_elems/occ.offchip_elems:.0f}x cut; paper: 31x)")

    r = compare_schemes(net, CAP)
    print(f"modeled speedup {r['speedup_occam']:.2f}x, energy saving "
          f"{r['energy_saving_occam']:.0%}")

    # deploy: grow the fleet and re-run the frontier search — the
    # best-throughput candidate replicates its bottleneck stages further
    # as chips appear (planning only; validate each with the event
    # simulator)
    m = MachineModel()
    print("\nfleet sweep (best-throughput candidate per fleet; a pipeline "
          "occupies sum(replicas) chips — paper §III-E sum-of-replicas "
          "accounting):")
    sweep = []
    for chips in (plan.n_spans, 2 * plan.n_spans, 4 * plan.n_spans):
        fr = occam.autoplan(net, occam.Fleet(chips=chips, vmem_elems=CAP,
                                             macs_per_s=m.macs_per_sec))
        cand = fr.best("throughput")
        placement = cand.placement()
        if placement.kind == occam.PIPELINE:
            rate = simulate(placement.stap, 500).throughput * m.macs_per_sec
            sim = f"simulated {rate:.4g} img/s"
        else:
            sim = "single chip"
        print(f"  {chips:2d}-chip fleet: {cand.kind} replicas "
              f"{cand.replicas} ({cand.chips} chips used) -> predicted "
              f"{cand.throughput:.4g} img/s, {sim}, "
              f"round width {cand.round_width}")
        sweep.append((chips, cand.kind, tuple(cand.replicas)))
    # the observed arrival rate closes the loop: the frontier hands back
    # the cheapest candidate meeting it (Session.scale does this per
    # session)
    rate = 0.5 * frontier.best("throughput").throughput
    cheap = frontier.for_rate(rate)
    print(f"\nfor_rate({rate:.0f} img/s): {cheap.kind} on {cheap.chips} "
          f"chips, replicas {cheap.replicas} "
          f"(predicted {cheap.throughput:.0f} img/s)")
    return {"n_spans": plan.n_spans, "boundaries": list(plan.boundaries),
            "traffic_cut": base.offchip_elems / occ.offchip_elems,
            "fleet_sweep": sweep}


if __name__ == "__main__":
    main()

"""Quickstart: Occam's four contributions in ~60 lines, the twin of
``examples/quickstart.py``.

Execution goes through the staged deployment API —
``occam.plan -> place -> compile -> run`` — on the GPU (the fused-span
kernel) unless ``--device cpu`` is given (its plain version).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import occam
from repro_torch.core.closure import max_tile_rows, span_closure_elems
from repro_torch.core.graph import chain
from repro_torch.core.partition import partition_cnn
from repro_torch.core.stap import plan_replication, simulate
from repro_torch.core.traffic import compare_schemes
from repro_torch.models import cnn
from repro_torch.models.api import resolve_device
from repro_torch.models.zoo import get_network

CAP = 3 * 1024 * 1024  # the paper's 3 MB on-chip memory, in INT8 elements
TINY = [("conv", 3, 1, 1, 8), ("conv", 3, 1, 1, 8), ("pool", 2, 2, 0, 0),
        ("conv", 3, 1, 1, 16)]


def _assert_close(got, want):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-5)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the deployments run (default: the GPU)")
    dev = resolve_device(ap.parse_args(argv).device)
    # fp32 comparisons against the cuDNN oracle: TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- C1/C2: dependence closure of ResNet-18 ----------------------------
    net = get_network("resnet18")
    print(f"ResNet-18: {net.n_layers} layers, "
          f"{net.total_weight_elems()/1e6:.1f}M weights")
    print(f"full-network dependence closure: "
          f"{span_closure_elems(net, 0, net.n_layers)/1e3:.0f}K elements")

    # --- C3: DP-optimal partitioning ----------------------------------------
    part = partition_cnn(net, CAP)
    print(f"optimal partitions @3MB: boundaries={part.boundaries} "
          f"(paper Table II: [12, 15, 16, 17])")
    tiles = []
    for sp in part.spans:
        tiles.append(max_tile_rows(net, sp.start, sp.end, CAP))
        print(f"  span({sp.start:3d},{sp.end:3d})  tile={tiles[-1]} full "
              f"rows")

    # --- the headline numbers ------------------------------------------------
    r = compare_schemes(net, CAP)
    print(f"off-chip traffic reduction: {r['traffic_reduction_occam']:.1f}x; "
          f"modeled speedup {r['speedup_occam']:.2f}x vs base, "
          f"{r['speedup_occam_vs_lf']:.2f}x vs Layer Fusion")

    # --- execution: Fleet -> autoplan -> Frontier -> deploy ------------------
    # miniature input for a quick run
    tiny = chain("tiny", TINY, in_h=16, in_w=16, in_ch=3)
    params = cnn.init_params(torch.Generator().manual_seed(0), tiny,
                             device=dev)
    x = torch.randn((16, 16, 3), generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    # describe the hardware once; the planner derives capacity + placement
    fleet = occam.Fleet(chips=1, vmem_elems=3000)
    frontier = occam.autoplan(tiny, fleet)  # capacity sweep x placements
    best = frontier.best("traffic")         # Pareto winner per objective
    plan = best.plan                        # an ordinary (schema v3) Plan
    dep = best.deploy(device=dev)           # place + compile inside
    y_stream = dep.run(params, x)
    y_ref = cnn.reference_forward(params, x, tiny)
    _assert_close(y_stream, y_ref)
    report = dep.report()                   # measured vs predicted
    assert report.matches_prediction
    print(f"staged execution == oracle; measured transfers "
          f"{int(report.measured_elems)} == DP prediction "
          f"{int(plan.predicted_transfers)} "
          f"(routes: {[r.route for r in plan.routes]})")
    # Eqn. 6's tile height is a planning knob: out_rows=2 makes the fused
    # kernel emit two output row-planes per step (half the steps, half
    # the resident-weight re-touches), same outputs
    plan_t2 = occam.plan(tiny, 3000, out_rows=2)
    y_t2 = plan_t2.place().compile(device=dev).run(params, x)
    _assert_close(y_t2, y_ref)
    print(f"out_rows={plan_t2.out_rows} plan: {plan_t2.n_spans} spans on "
          f"2-row tiles, same outputs")
    # frontiers (and the plans inside them) are serializable: ship the
    # JSON, deploy on the serving host without re-running the search
    frontier2 = occam.frontier_from_json(frontier.to_json())
    assert frontier2.best("traffic").plan.boundaries == plan.boundaries
    plan2 = occam.plan_from_json(plan.to_json())
    assert plan2.boundaries == plan.boundaries
    assert occam.plan_from_json(plan_t2.to_json()).out_rows == 2
    # shipped plans are audited artifacts: occam.audit statically
    # re-proves a document's invariants without executing anything — a
    # corrupted document is rejected with a stable rule ID
    bad_doc = json.loads(plan.to_json())
    bad_doc["capacity_elems"] = 100          # lie: the spans no longer fit
    bad = occam.audit(bad_doc)
    assert not bad.ok and "OCM011" in bad.rules()
    assert occam.audit(plan).ok              # the honest plan audits clean
    print(f"audit: corrupted plan rejected ({', '.join(bad.rules())}); "
          f"honest plan passes clean")

    # --- measured-cost planning: calibrate -> rescore -> redeploy -----------
    # analytic rates miss dispatch/padding constants; measure the live
    # deployment, fit a CostModel, re-rank the frontier under it — the DP
    # never re-runs, and cached deployments carry over (no recompile)
    cm = occam.calibrate(dep, params, rounds=2)
    print(f"calibrated: {cm.macs_per_s:.3g} MAC/s fitted "
          f"(x{cm.compute_overhead_factor:.0f} off the analytic roofline), "
          f"per-stage overhead {cm.stage_overhead_s * 1e6:.0f}us")
    recal = frontier.rescore(cm)
    dep2 = recal.best("traffic").deploy(device=dev)
    assert dep2 is dep                                    # cache survived
    assert recal.best("traffic").plan.calibration is cm   # ships in plan v4
    # sum-of-replicas placement (paper §III-E): STAP stages are
    # asynchronous, so a 4-3-2 pipeline occupies 9 chips — not the
    # 12-chip (stage x max_replicas) rectangle
    asg = occam.pack_replicas((4, 3, 2))
    print(f"4-3-2 packed placement: {asg.n_chips} chips "
          f"(rect mesh {asg.rect_chips}; saves {asg.chips_saved})")

    # --- quantized spans: dtype as a planning axis ---------------------------
    # an int8 boundary policy shrinks the DP's byte-denominated closures
    # 4x: larger spans fit, the cut moves, and off-chip traffic drops in
    # bytes — at a bounded accuracy cost
    plan_q = occam.plan(tiny, 3000, dtype_policy="int8")
    plan_f = occam.plan(tiny, 3000)
    assert plan_q.predicted.offchip_bytes < plan_f.predicted.offchip_bytes
    dep_q = plan_q.place().compile(device=dev)
    y_q = dep_q.run(params, x)
    rep_q = dep_q.report()
    assert rep_q.matches_prediction_bytes      # byte-exact model == machine
    err_q = float((y_q - y_ref).abs().max())
    print(f"int8-boundary plan: {plan_q.n_spans} spans "
          f"({plan_f.n_spans} at fp32), "
          f"{plan_q.predicted.offchip_bytes / 1e3:.1f}KB/image off-chip vs "
          f"{plan_f.predicted.offchip_bytes / 1e3:.1f}KB at fp32, "
          f"max |err| {err_q:.3f} vs the fp32 reference")
    assert occam.plan_from_json(plan_q.to_json()).quant == plan_q.quant

    # --- C4: STAP -----------------------------------------------------------
    splan = plan_replication([15, 35, 40, 10], target_period=20)
    # sub-bottleneck arrival rate: latency stays the bare pipeline sum
    stats = simulate(splan, n_jobs=100,
                     arrival_period=splan.bottleneck_period)
    print(f"STAP 15-35-40-10 with replicas {splan.replicas}: "
          f"throughput 1/{1/stats.throughput:.0f} per unit (paper: 1/20), "
          f"latency {stats.mean_latency:.0f} (paper: 100)")
    # the same replication planning, fleet-aware: grow the fleet and the
    # frontier's best-throughput candidate picks up replicated pipelines
    # (planning only — no devices touched)
    big = occam.autoplan(tiny, occam.Fleet(chips=2 * plan.n_spans + 2,
                                           vmem_elems=3000))
    fast = big.best("throughput")
    print(f"autoplan on a {big.fleet.chips}-chip fleet: best-throughput "
          f"candidate is a {fast.kind} placement, replicas {fast.replicas}, "
          f"{fast.chips} chips, x{best.period / fast.period:.1f} predicted "
          f"throughput over the 1-chip fleet "
          f"({len(big)} Pareto candidates on the frontier)")
    return {"boundaries": part.boundaries, "tiles": tiles, "schemes": r,
            "frontier": frontier, "big_frontier": big,
            "routes": [r.route for r in plan.routes],
            "params": params, "x": x, "y": y_stream, "y_t2": y_t2,
            "plan_t2": plan_t2, "plan_q": plan_q,
            "measured_elems": int(report.measured_elems),
            "predicted_transfers": int(plan.predicted_transfers),
            "max_abs_err": float((y_stream - y_ref).abs().max()),
            "int8_max_abs_err": err_q,
            "stap_replicas": list(splan.replicas),
            "stap_stats": (stats.throughput, stats.mean_latency)}


if __name__ == "__main__":
    main()

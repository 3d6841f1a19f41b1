"""Measured-cost planning benchmark: does ``occam.calibrate`` +
``Frontier.rescore`` predict the machine better than the analytic
roofline the frontier was scored with? The twin of
``benchmarks/occam_calibrate.py``.

Flow: ``autoplan`` a fleet frontier, deploy the analytic winner, time
its steady serving rate, calibrate a :class:`~repro_torch.occam.CostModel`
from isolated stage/hop measurements, re-score the frontier under it,
and compare both predictions against the measured steady period. The
headline is the prediction-error improvement factor — the analytic
prediction's multiplicative miss over the calibrated one's (> 1 means
calibration helped). The reference's docstring expects the factor to
approach 1 from above on real accelerators; a GPU run records it either
way.

The doc also records the §III-E sum-of-replicas accounting: how many
chips the packed placements on the frontier save versus rectangular
meshes (pure planning: equal to the reference's).

Every mesh position on one device (``cuda:0`` by default), in-process;
a timed window's clock stops after ``Session.sync``. Writes
``results/BENCH_torch_calibrate.json``:

    PYTHONPATH=src python -m repro_torch.benchmarks.occam_calibrate [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

from . import common

HW = 16
CAPACITY = 6000
CHIPS = 6
MICROBATCH = 2
ROUNDS_TIMED = 16
CALIBRATE_ROUNDS = 3

# every BENCH_torch_calibrate.json must carry these (the reference's
# schema)
REQUIRED_KEYS = (
    "audit",
    "net", "fleet", "boundaries", "replicas", "packing", "chips",
    "chips_saved_on_frontier", "round_batch", "rounds_timed",
    "session_compile_count", "measured_period_us", "analytic_period_us",
    "calibrated_period_us", "analytic_miss_factor",
    "calibrated_miss_factor", "error_improvement", "winner_changed",
    "calibration", "zoo_chips_saved",
)

# planning-only sum-of-replicas sweep (no devices): what the §III-E
# accounting saves on the paper zoo at the paper's 3 MB / 16 chips
ZOO_NETS = ("alexnet", "vggnet", "resnet18")
ZOO_VMEM = 3 * 1024 * 1024
ZOO_CHIPS = 16


def validate_doc(doc: dict) -> None:
    """Schema gate: raise if ``doc`` is not a BENCH_calibrate document."""
    missing = [k for k in REQUIRED_KEYS if k not in doc]
    if missing:
        raise ValueError(f"BENCH_calibrate doc missing keys: {missing}")
    cal = doc["calibration"]
    for k in ("version", "macs_per_s", "stage_overhead_s",
              "link_s_per_elem", "samples", "residual"):
        if k not in cal:
            raise ValueError(f"calibration block missing {k!r}")
    if doc["measured_period_us"] <= 0 or doc["calibrated_period_us"] <= 0:
        raise ValueError("periods must be positive")
    if doc["error_improvement"] <= 0:
        raise ValueError("error_improvement must be positive")


def _vgg(hw: int = HW):
    from repro_torch.core.graph import chain

    C, P = "conv", "pool"
    specs = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 16)]
    return chain("vgg_mini", specs, in_h=hw, in_w=hw, in_ch=3)


def zoo_chips_saved(nets=ZOO_NETS, chips: int = ZOO_CHIPS,
                    vmem: int = ZOO_VMEM) -> list:
    """Per zoo net: the best-throughput candidate's replica vector and
    the chips the packed placement saves over the rectangular mesh."""
    from repro_torch import occam
    from repro_torch.models.zoo import get_network

    rows = []
    for name in nets:
        fr = occam.autoplan(get_network(name),
                            occam.Fleet(chips=chips, vmem_elems=vmem))
        best = fr.best("throughput")
        rect = len(best.replicas) * max(best.replicas)
        rows.append({
            "net": name,
            "replicas": list(best.replicas),
            "chips_packed": best.chips,
            "chips_rect": rect,
            "chips_saved": rect - best.chips,
            "frontier_chips_saved": sum(
                len(c.replicas) * max(c.replicas) - sum(c.replicas)
                for c in fr if c.kind == occam.PIPELINE),
        })
    return rows


def _measure_period(dep, params, net, rounds: int = ROUNDS_TIMED):
    """Steady seconds per image of one deployment: warm the build,
    pre-fill the ring, then time back-to-back full-round submits."""
    rb, _mb = dep.placement.serve_geometry(None)
    xs = common.images((rb,) + net.map_shape(0), 1, dep.device)
    depth = getattr(dep.placement, "ring_depth", 1)
    with dep.serve(params, max_pending=rounds + depth + 4) as sess:
        sess.submit(xs)
        sess.results()
        for _ in range(depth):
            sess.submit(xs)
        sess.sync()
        t0 = time.perf_counter()
        for _ in range(rounds):
            sess.submit(xs)
        sess.sync()
        wall = time.perf_counter() - t0
        sess.results()
        compile_count = sess.compile_count
    return wall / (rounds * rb), rb, compile_count


def calibrate_measurement(chips: int = CHIPS, vmem: int = CAPACITY,
                          rounds_timed: int = ROUNDS_TIMED,
                          device=None) -> dict:
    """One in-process measurement on ``device`` (default ``cuda:0``)."""
    from repro_torch import occam
    from repro_torch.models import cnn

    from .audit_stamp import audit_verdict

    dev = common.resolve_device(device)
    net = _vgg()
    params = cnn.init_params(common.generator(0), net, device=dev)
    fleet = occam.Fleet(chips=chips, vmem_elems=vmem)
    frontier = occam.autoplan(net, fleet, batch=MICROBATCH)
    analytic_best = frontier.best()
    dep = analytic_best.deploy(device=dev)

    measured, rb, compile_count = _measure_period(
        dep, params, net, rounds_timed)

    cm = occam.calibrate(dep, params, rounds=CALIBRATE_ROUNDS)
    rescored = frontier.rescore(cm)
    winner = rescored.best()
    winner_changed = (winner.kind, winner.replicas) != \
        (analytic_best.kind, analytic_best.replicas)
    if winner_changed:
        # the calibrated pick is the one whose prediction must hold
        measured, rb, _cc = _measure_period(
            winner.deploy(device=dev), params, net, rounds_timed)

    analytic_period = next(
        c.period for c in frontier
        if c.kind == winner.kind and c.replicas == winner.replicas
        and c.plan.boundaries == winner.plan.boundaries)

    # multiplicative miss factor (how many x the prediction is off,
    # either direction): relative error saturates at 1.0 when the
    # analytic roofline is orders of magnitude fast, hiding the gap
    def miss(pred: float) -> float:
        return max(pred / measured, measured / pred)

    analytic_miss = miss(analytic_period)
    calibrated_miss = miss(winner.period)
    improvement = analytic_miss / calibrated_miss

    placement = winner.placement()
    saved = sum(
        len(c.replicas) * max(c.replicas) - sum(c.replicas)
        for c in frontier if c.kind == occam.PIPELINE)
    return {
        "device": common.device_block(dev),
        "audit": audit_verdict(winner),
        "net": net.name,
        "fleet": {"chips": chips, "vmem_elems": vmem},
        "boundaries": winner.plan.boundaries,
        "replicas": list(winner.replicas),
        "packing": placement.packing,
        "chips": winner.chips,
        "chips_saved_on_frontier": saved,
        "round_batch": rb,
        "rounds_timed": rounds_timed,
        "session_compile_count": compile_count,
        "measured_period_us": round(measured * 1e6, 3),
        "analytic_period_us": round(analytic_period * 1e6, 3),
        "calibrated_period_us": round(winner.period * 1e6, 3),
        "analytic_miss_factor": round(analytic_miss, 4),
        "calibrated_miss_factor": round(calibrated_miss, 4),
        "calibrated_over_measured": round(winner.period / measured, 4),
        "error_improvement": round(improvement, 4),
        "winner_changed": winner_changed,
        "calibration": cm.to_dict(),
        "zoo_chips_saved": zoo_chips_saved(),
    }


def occam_calibrate(device=None):
    """Harness entry (``repro_torch.benchmarks.run``): measure in-process,
    validate and write the document, and report the prediction-error
    improvement factor of the calibrated cost model over the analytic
    roofline."""
    row = calibrate_measurement(device=device)
    validate_doc(row)
    common.write_doc(common.out_path("calibrate"), row)
    return [row], row["error_improvement"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where every mesh position runs (default: cuda:0)")
    args = ap.parse_args(argv)
    (row,), _ = occam_calibrate(args.device)
    print(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()

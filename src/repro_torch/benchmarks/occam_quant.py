"""Quantized-span planning and execution benchmark (``occam.quant``); the
twin of ``benchmarks/occam_quant.py``.

Two claims, measured:

1. **Planning** — dtype is a real planning axis, not a post-hoc scale
   factor. For each zoo net, the byte-denominated DP under the ``int8``
   policy (int8 activations/boundaries, fp32 weights) must move strictly
   fewer boundary bytes per image than the fp32 plan of the same fleet
   AND grow at least one fitted span (the 4x-smaller closures change the
   argmin, not just the objective's unit). Pure planning: the rows equal
   the reference's.
2. **Execution** — model == machine holds in *bytes*: a quantized
   deployment's measured byte traffic equals the plan's byte-denominated
   prediction exactly (every mesh position on one device, ``cuda:0`` by
   default, in-process), and the quantized outputs stay within a
   bounded tolerance of the fp32 reference (the accuracy cost the
   frontier's ``quant_cost`` axis trades against).

The headline is the int8-over-fp32 off-chip byte reduction on the
largest zoo net measured. Writes ``results/BENCH_torch_quant.json``:

    PYTHONPATH=src python -m repro_torch.benchmarks.occam_quant [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from . import common

# planning sweep: zoo nets at a capacity where fp32 needs many spans
ZOO_NETS = ("alexnet", "resnet18", "vggnet")
ZOO_CAPACITY = 400_000
POLICIES = ("fp32", "bf16", "int8")

# execution case: the reference's small pipelined net
HW = 16
CAPACITY = 6000
BATCH = 6
INT8_TOLERANCE = 0.25   # max |int8 - fp32| on vgg_mini activations

# every BENCH_torch_quant.json must carry these (the reference's schema)
REQUIRED_KEYS = (
    "audit", "zoo_capacity_elems", "policies", "zoo", "execution",
    "bytes_reduction_int8", "span_growth_nets",
)


def validate_doc(doc: dict) -> None:
    """Schema gate: raise if ``doc`` is not a BENCH_quant document."""
    missing = [k for k in REQUIRED_KEYS if k not in doc]
    if missing:
        raise ValueError(f"BENCH_quant doc missing keys: {missing}")
    if doc["bytes_reduction_int8"] <= 1.0:
        raise ValueError("int8 must strictly reduce off-chip bytes")
    if not doc["span_growth_nets"]:
        raise ValueError("int8 must grow a fitted span on >= 1 zoo net")
    for row in doc["zoo"]:
        for k in ("net", "policy", "n_spans", "boundaries",
                  "offchip_bytes_per_image", "boundary_bytes_per_image"):
            if k not in row:
                raise ValueError(f"zoo row missing {k!r}")
    ex = doc["execution"]
    for k in ("net", "matches_prediction_bytes", "payload_bytes_per_elem",
              "link_bytes_ratio_int8", "max_abs_err_int8",
              "tolerance"):
        if k not in ex:
            raise ValueError(f"execution block missing {k!r}")
    if not ex["matches_prediction_bytes"]:
        raise ValueError("byte-denominated model==machine must hold")
    if ex["max_abs_err_int8"] > ex["tolerance"]:
        raise ValueError("int8 accuracy cost exceeded tolerance")


def _span_lens(net, boundaries) -> list:
    cuts = [0] + list(boundaries) + [net.n_layers]
    return [b - a for a, b in zip(cuts[:-1], cuts[1:])]


def zoo_rows(nets=ZOO_NETS, capacity: int = ZOO_CAPACITY) -> list:
    """Per (net, policy): the byte-denominated plan's shape and traffic."""
    from repro_torch import occam
    from repro_torch.models.zoo import get_network

    rows = []
    for name in nets:
        net = get_network(name)
        for pol in POLICIES:
            plan = occam.plan(net, capacity, dtype_policy=pol)
            pred = plan.predicted
            rows.append({
                "net": name,
                "policy": pol,
                "n_spans": plan.n_spans,
                "boundaries": list(plan.boundaries),
                "span_lens": _span_lens(net, plan.boundaries),
                "offchip_bytes_per_image": pred.offchip_bytes,
                "boundary_bytes_per_image": pred.boundary_bytes,
            })
    return rows


def _vgg(hw: int = HW):
    from repro_torch.core.graph import chain

    C, P = "conv", "pool"
    specs = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 16)]
    return chain("vgg_mini", specs, in_h=hw, in_w=hw, in_ch=3)


def execution_row(device=None) -> dict:
    """Run fp32 and int8 plans of the same net as pipelines with every
    mesh position on ``device``: byte-exact traffic accounting,
    link-byte reduction, accuracy cost."""
    from repro_torch import occam
    from repro_torch.models import cnn

    from .audit_stamp import audit_verdict

    dev = common.resolve_device(device)
    net = _vgg()
    params = cnn.init_params(common.generator(0), net, device=dev)
    xs = common.images((BATCH, HW, HW, 3), 1, dev) * 0.5

    deps, reports, ys = {}, {}, {}
    for pol in ("fp32", "int8"):
        plan = occam.plan(net, CAPACITY, batch=BATCH, dtype_policy=pol)
        dep = plan.place(chips=plan.n_spans).compile(device=dev)
        ys[pol] = dep.run(params, xs)
        deps[pol] = dep
        reports[pol] = dep.report()
    err = float((ys["int8"] - ys["fp32"]).abs().max())
    pipe = {pol: deps[pol].pipeline(BATCH).report() for pol in deps}
    return {
        "device": common.device_block(dev),
        "audit": audit_verdict(deps["fp32"], deps["int8"]),
        "net": net.name,
        "capacity_elems": CAPACITY,
        "matches_prediction_bytes": bool(
            reports["int8"].matches_prediction_bytes
            and reports["fp32"].matches_prediction_bytes),
        "payload_bytes_per_elem": pipe["int8"]["payload_bytes_per_elem"],
        "link_bytes_per_image_fp32": pipe["fp32"]["link_bytes_per_image"],
        "link_bytes_per_image_int8": pipe["int8"]["link_bytes_per_image"],
        "link_bytes_ratio_int8": (
            pipe["int8"]["link_bytes_per_image"]
            / max(pipe["fp32"]["link_bytes_per_image"], 1e-9)),
        "max_abs_err_int8": err,
        "tolerance": INT8_TOLERANCE,
    }


def quant_measurement(device=None) -> dict:
    """One in-process measurement: the zoo's plans on the host, the
    execution row on ``device`` (default ``cuda:0``)."""
    zoo = zoo_rows()
    by = {(r["net"], r["policy"]): r for r in zoo}
    growth = []
    reductions = []
    for name in ZOO_NETS:
        f32, i8 = by[(name, "fp32")], by[(name, "int8")]
        reductions.append(f32["offchip_bytes_per_image"]
                          / max(i8["offchip_bytes_per_image"], 1e-9))
        pairs = zip(i8["span_lens"], f32["span_lens"])
        if any(a > b for a, b in pairs) or \
                i8["n_spans"] < f32["n_spans"]:
            growth.append(name)
    execution = execution_row(device)
    return {
        "device": execution.pop("device"),
        "audit": execution.pop("audit"),
        "zoo_capacity_elems": ZOO_CAPACITY,
        "policies": list(POLICIES),
        "zoo": zoo,
        "execution": execution,
        "bytes_reduction_int8": round(max(reductions), 3),
        "span_growth_nets": growth,
    }


def occam_quant(device=None):
    """Harness entry (``repro_torch.benchmarks.run``): measure in-process,
    validate and write the document, and report the int8-over-fp32
    off-chip byte reduction."""
    row = quant_measurement(device)
    validate_doc(row)
    common.write_doc(common.out_path("quant"), row)
    return [row], row["bytes_reduction_int8"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where every mesh position runs (default: cuda:0)")
    args = ap.parse_args(argv)
    (row,), _ = occam_quant(args.device)
    print(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()

"""The benchmark twins of the paper's tables (``repro_torch.benchmarks
.tables``) against the reference's ``benchmarks/tables.py``: every
analytic function's rows and ``derived`` exactly equal; the span-engine
twin's analytic fields, from a run on the CPU at 16x16, equal to what
the reference's ``occam_span_engine`` derives for the same nets from its
own planning core; the STAP benchmark's net cut at [2, 7] as the
reference's."""
import json
from pathlib import Path

import pytest
import torch

from benchmarks import occam_stap as j_occam_stap
from benchmarks import tables as j_tables
from repro.core import closure as j_closure
from repro.core.graph import chain as j_chain
from repro.core.partition import partition_cnn as j_partition_cnn
from repro.runtime import span_engine as j_span_engine
from repro_torch.benchmarks import occam_stap, tables

ROOT = Path(__file__).resolve().parents[1]
ANALYTIC = ["table2_partitions", "table3_misses", "table4_traffic",
            "fig7_capacity", "fig8_speedup", "fig9_energy",
            "cache_sensitivity", "stap_example"]
# the paper's headlines as the reference computes them
DERIVED = {"table2_partitions": 79, "table3_misses": 0.05875,
           "stap_example": 1.0}


@pytest.mark.parametrize("name", ANALYTIC)
def test_analytic_table_equals_reference(name):
    rows, derived = getattr(tables, name)()
    j_rows, j_derived = getattr(j_tables, name)()
    assert rows == j_rows
    assert derived == j_derived
    if name in DERIVED:
        assert derived == DERIVED[name]


def _reference_analytic(hw):
    """The analytic fields of the reference's ``occam_span_engine`` at
    ``hw``, from its own planning core (``tables.py:120-250``: the same
    nets, partitions, routes and schedules)."""
    C, P = "conv", "pool"
    specs = [(C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 32), (C, 3, 1, 1, 32), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 32)]
    net = j_chain("vgg_mini", specs, in_h=hw, in_w=hw, in_ch=3)
    res = j_partition_cnn(net, 24 * 1024)
    routes = j_span_engine.plan_routes(net, res)
    rnet = j_chain("res_mini", [(C, 3, 1, 1, 16)] * 5, in_h=hw, in_w=hw,
                   in_ch=3, residual_edges=((0, 2), (1, 4)))
    rres = j_partition_cnn(rnet, 24 * 1024)
    rroutes = j_span_engine.plan_routes(rnet, rres)
    cuts = [0] + list(res.boundaries) + [net.n_layers]
    sweep = []
    for t in (1, 2, 4):
        steps = touch = 0
        for a, b in zip(cuts, cuts[1:]):
            tt = max(1, min(t, net.map_shape(b)[0]))
            n = j_closure.span_schedule(net, a, b, out_rows=tt).n_steps
            steps += n
            touch += n * net.span_weight_elems(a, b)
        sweep.append((t, steps, touch))
    kernel = j_span_engine.ROUTE_PALLAS
    return {
        "vgg_mini": (net.name, net.n_layers, list(res.boundaries),
                     sum(r.route == kernel for r in routes), len(routes)),
        "res_mini": (rnet.name, rnet.n_layers,
                     [list(e) for e in rnet.residual_edges],
                     list(rres.boundaries),
                     sum(r.route == kernel for r in rroutes), len(rroutes)),
        "sweep": sweep,
    }


def test_span_engine_analytic_fields_equal_reference(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "span_engine.json"
        (row, res_row), derived = tables.occam_span_engine(
            hw=16, reps=1, device="cpu", out_json=str(out))
    finally:
        torch.set_num_threads(threads)
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["vgg_mini"] == row
    want = _reference_analytic(16)
    assert (row["net"], row["layers"], row["boundaries"],
            row["spans_on_cuda_kernel"], row["spans_total"]) \
        == want["vgg_mini"]
    assert (res_row["net"], res_row["layers"], res_row["residual_edges"],
            res_row["boundaries"], res_row["spans_on_cuda_kernel"],
            res_row["spans_total"]) == want["res_mini"]
    assert [(e["out_rows"], e["kernel_grid_steps"],
             e["weight_touch_elems"]) for e in doc["out_rows_sweep"]] \
        == want["sweep"]
    # derived as the reference defines it, with its 10x floor recorded
    assert row["speedup_compiled_vs_interpreted"] == round(derived, 1)
    assert row["floor_10x_met"] == (derived >= 10)
    # every engine's output equals the oracle's on the CPU
    for key in ("max_abs_err_interpreted", "max_abs_err_compiled",
                "max_abs_err_cuda_kernel"):
        assert row[key] <= 1e-5 * row["max_abs_oracle"]
    assert res_row["max_abs_err_cuda_kernel"] <= 1e-5
    # the reference's keys, the Pallas names renamed to the port's
    ref_row = json.loads((ROOT / "results" / "BENCH_span_engine.json")
                         .read_text())["vgg_mini"]
    assert {k.replace("pallas_interpret", "cuda_kernel")
            .replace("pallas_kernel", "cuda_kernel")
            for k in ref_row} <= set(row)


def test_stap_bench_case_cuts_like_the_reference():
    net, res = occam_stap.bench_case()
    j_net, j_res = j_occam_stap.bench_case()
    assert list(res.boundaries) == list(j_res.boundaries) == [2, 7]
    assert res.transfers == j_res.transfers
    assert [(l.kind, l.k, l.stride, l.padding, l.out_ch)
            for l in net.layers] == [(l.kind, l.k, l.stride, l.padding,
                                      l.out_ch) for l in j_net.layers]
    assert (occam_stap.CAPACITY, occam_stap.HW, occam_stap.BATCH,
            occam_stap.MICROBATCH, occam_stap.N_DEVICES) == (
        j_occam_stap.CAPACITY, j_occam_stap.HW, j_occam_stap.BATCH,
        j_occam_stap.MICROBATCH, j_occam_stap.N_DEVICES)

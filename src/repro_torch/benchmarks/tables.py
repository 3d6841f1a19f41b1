"""One benchmark per paper table/figure (analytical reproduction) + the
span-engine execution benchmark (measured, not modeled); the twin of
``benchmarks/tables.py``.

Each function returns (rows, derived) where ``derived`` is the headline
number the paper reports for that artifact. The analytic functions read
only the port's copies of the planning core, so their rows and
``derived`` equal the reference's exactly.
"""
from __future__ import annotations

import time

from repro_torch.core.partition import partition_cnn, partition_report
from repro_torch.core.stap import paper_example, simulate
from repro_torch.core.traffic import compare_schemes, geomean
from repro_torch.models.zoo import PAPER_NETWORKS, get_network

from . import common

CAP_3MB = 3 * 1024 * 1024
CAP_6MB = 6 * 1024 * 1024


def table2_partitions(cap: int = CAP_3MB):
    """Table II: optimal partitions + tile dims per network @3MB."""
    rows = []
    for name in PAPER_NETWORKS:
        net = get_network(name)
        rep = partition_report(net, cap)
        rows.append({
            "network": name,
            "layers": net.n_layers,
            "boundaries": [r["start"] for r in rep[1:]],
            "tiles": [(r["start"], r["end"], r["occam_tile_rows"])
                      for r in rep],
        })
    derived = sum(len(r["boundaries"]) + 1 for r in rows)  # total spans
    return rows, derived


def table3_misses(cap: int = CAP_3MB):
    """Table III: normalized miss + instruction counts (model)."""
    rows = []
    for name in PAPER_NETWORKS:
        r = compare_schemes(get_network(name), cap)
        rows.append({
            "network": name,
            "miss_occam": round(r["norm_miss"]["occam"], 3),
            "miss_lf": round(r["norm_miss"]["layer_fusion"], 3),
            "instr_occam": 1.04,
            "instr_lf": round(r["norm_instr"]["layer_fusion"], 2),
        })
    mean_miss = sum(r["miss_occam"] for r in rows) / len(rows)
    return rows, mean_miss  # paper: ~0.05 (21x cut)


def table4_traffic(cap: int = CAP_3MB):
    """Table IV / headline: off-chip traffic reduction (paper: 7x/31x/43x,
    21x geomean)."""
    rows, reds = [], []
    for name in PAPER_NETWORKS:
        r = compare_schemes(get_network(name), cap)
        red = r["traffic_reduction_occam"]
        rows.append({"network": name, "reduction": round(red, 1)})
        reds.append(red)
    return rows, geomean(reds)


def fig7_capacity(cap: int = CAP_3MB):
    """Fig. 7: capacity split filters vs dependence closure (ResNet-152)."""
    rep = partition_report(get_network("resnet152"), cap)
    rows = [{"span": (r["start"], r["end"]),
             "filters_frac": r["weight_elems"]
             / max(r["weight_elems"] + r["closure_elems"], 1)}
            for r in rep]
    mean_frac = sum(r["filters_frac"] for r in rows) / len(rows)
    return rows, mean_frac  # paper: most capacity goes to filters


def fig8_speedup(cap: int = CAP_3MB):
    """Fig. 8: kernel speedups over base (paper: 2.06x occam, 1.52x LF)."""
    rows, spd, spd_lf = [], [], []
    for name in PAPER_NETWORKS:
        r = compare_schemes(get_network(name), cap)
        rows.append({"network": name,
                     "speedup_occam": round(r["speedup_occam"], 2),
                     "speedup_lf": round(r["speedup_lf"], 2)})
        spd.append(r["speedup_occam"])
        spd_lf.append(r["speedup_lf"])
    return rows, geomean(spd)


def fig9_energy(cap: int = CAP_3MB):
    """Fig. 9: energy (paper: -33% occam, -12% equal-cost LF)."""
    rows, sav = [], []
    for name in PAPER_NETWORKS:
        r = compare_schemes(get_network(name), cap)
        e = r["energy"]
        rows.append({
            "network": name,
            "saving_occam": round(r["energy_saving_occam"], 3),
            "saving_lf": round(r["energy_saving_lf"], 3),
            "base_split_compute": round(
                e["base"]["compute_pj"] / e["base"]["total_pj"], 2),
        })
        sav.append(r["energy_saving_occam"])
    return rows, sum(sav) / len(sav)


def cache_sensitivity():
    """§V-B2: 3MB -> 6MB improves Occam (fewer spans, less traffic)."""
    rows = []
    for name in ("vggnet", "resnet101", "resnet152"):
        net = get_network(name)
        t3 = partition_cnn(net, CAP_3MB).transfers
        t6 = partition_cnn(net, CAP_6MB).transfers
        rows.append({"network": name, "traffic_3mb": t3, "traffic_6mb": t6,
                     "ratio": round(t3 / t6, 2)})
    return rows, sum(r["ratio"] for r in rows) / len(rows)


def _vgg_mini(hw: int):
    from repro_torch.core.graph import chain

    C, P = "conv", "pool"
    specs = [(C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 32), (C, 3, 1, 1, 32), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 32)]
    return chain("vgg_mini", specs, in_h=hw, in_w=hw, in_ch=3)


def _res_mini(hw: int):
    from repro_torch.core.graph import chain

    rspecs = [("conv", 3, 1, 1, 16)] * 5
    return chain("res_mini", rspecs, in_h=hw, in_w=hw, in_ch=3,
                 residual_edges=((0, 2), (1, 4)))


def occam_span_engine(hw: int = 32, reps: int = 5,
                      out_json: str | None = None, device=None):
    """Measured span-engine trajectory: us/image on a VGG-style stack for
    the cuDNN oracle vs the interpreted RowRing loop vs the scan engine
    (the kernel's plain version) vs the fused-span CUDA kernel (the
    ``pallas`` route: ``execute_partition`` -> ``span_cuda_call``).

    Writes ``results/BENCH_torch_span_engine.json`` (or ``out_json``).
    ``derived`` is the scan engine's speedup over the interpreted
    streaming path, as the reference defines it (its acceptance floor:
    10x, recorded in ``floor_10x_met``); the kernel's speedup over the
    interpreted path sits beside it. Keys that named the Pallas kernel
    name the CUDA kernel (``us_cuda_kernel``, ``spans_on_cuda_kernel``).
    Each timed call ends in a device synchronize before the clock is
    read. The kernel and scan outputs are held against the oracle
    (``max_abs_err_*`` beside ``max_abs_oracle``).
    """
    from repro_torch.core import closure as _closure
    from repro_torch.models import cnn
    from repro_torch.runtime import span_engine

    dev = common.resolve_device(device)
    common.full_fp32()
    net = _vgg_mini(hw)
    res = partition_cnn(net, 24 * 1024)  # forces a 3-span partition @hw=32
    params = cnn.init_params(common.generator(0), net, device=dev)
    x = common.images((hw, hw, 3), 1, dev)

    def timed(fn, n=reps, warm=1):
        for _ in range(warm):
            fn()
            common.block(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            common.block(dev)
        return (time.perf_counter() - t0) / n * 1e6

    def once(fn):
        t0 = time.perf_counter()
        out = fn()
        common.block(dev)
        return out, (time.perf_counter() - t0) * 1e6

    def err(got, want):
        return float((got.float() - want.float()).abs().max())

    y_oracle = cnn.reference_forward(params, x, net)
    us_oracle = timed(lambda: cnn.reference_forward(params, x, net))
    # interpreted: warm once so one-time set-up doesn't inflate the
    # tracked speedup, then time one dispatch-bound run
    cnn.occam_forward(params, x, net, res.boundaries, mode="interpreted")
    common.block(dev)
    y_interp, us_interp = once(lambda: cnn.occam_forward(
        params, x, net, res.boundaries, mode="interpreted"))
    y_comp = cnn.occam_forward(params, x, net, res.boundaries,
                               mode="compiled")
    us_comp = timed(lambda: cnn.occam_forward(params, x, net, res.boundaries,
                                              mode="compiled"))
    us_jit = timed(lambda: cnn.occam_forward_jit(params, x, net,
                                                 tuple(res.boundaries)))
    routes = span_engine.plan_routes(net, res)
    kernel_spans = sum(r.route == span_engine.ROUTE_KERNEL for r in routes)
    y_kernel = span_engine.execute_partition(params, x, net, res)
    us_kernel = timed(lambda: span_engine.execute_partition(
        params, x, net, res))
    derived = us_interp / us_comp
    row = {
        "net": net.name, "layers": net.n_layers, "hw": hw,
        "boundaries": list(res.boundaries),
        "spans_on_cuda_kernel": kernel_spans, "spans_total": len(routes),
        "us_oracle_jit": round(us_oracle, 1),
        "us_interpreted": round(us_interp, 1),
        "us_compiled": round(us_comp, 1),
        "us_whole_net_jit": round(us_jit, 1),
        "us_cuda_kernel": round(us_kernel, 1),
        "speedup_compiled_vs_interpreted": round(derived, 1),
        "floor_10x_met": derived >= 10.0,
        "speedup_cuda_kernel_vs_interpreted": round(us_interp / us_kernel,
                                                    1),
        "max_abs_oracle": float(y_oracle.abs().max()),
        "max_abs_err_interpreted": err(y_interp, y_oracle),
        "max_abs_err_compiled": err(y_comp, y_oracle),
        "max_abs_err_cuda_kernel": err(y_kernel, y_oracle),
    }

    # residual net: a partition-crossing edge plus an in-span edge — the
    # spans route to the fused kernel (no scan substitution) and match
    # the oracle; tracked so residual-kernel regressions show up here
    rnet = _res_mini(hw)
    rres = partition_cnn(rnet, 24 * 1024)
    rparams = cnn.init_params(common.generator(2), rnet, device=dev)
    rx = common.images((hw, hw, 3), 3, dev)
    rroutes = span_engine.plan_routes(rnet, rres)
    us_res_comp = timed(lambda: cnn.occam_forward(
        rparams, rx, rnet, rres.boundaries, mode="compiled"))
    y_res, us_res_kernel = once(lambda: span_engine.execute_partition(
        rparams, rx, rnet, rres))
    res_row = {
        "net": rnet.name, "layers": rnet.n_layers, "hw": hw,
        "residual_edges": [list(e) for e in rnet.residual_edges],
        "boundaries": list(rres.boundaries),
        "spans_on_cuda_kernel": sum(
            r.route == span_engine.ROUTE_KERNEL for r in rroutes),
        "spans_total": len(rroutes),
        "us_compiled": round(us_res_comp, 1),
        "us_cuda_kernel": round(us_res_kernel, 1),
        "max_abs_err_cuda_kernel": err(
            y_res, cnn.reference_forward(rparams, rx, rnet)),
    }

    # out_rows tile sweep: t output row-planes per step (Eqn. 6
    # amortization) on the forced-scan engine (identical schedule
    # semantics to the kernel) and the kernel, whose step count shrinks
    # by t. Warm steady-state times
    sweep = []
    cuts = [0] + list(res.boundaries) + [net.n_layers]
    for t in (1, 2, 4):
        sroutes = span_engine.plan_routes(net, res, backend="scan",
                                          out_rows=t)
        us_t = timed(lambda: span_engine.execute_partition(
            params, x, net, res, routes=sroutes, out_rows=t))
        # machine-schedule metrics Eqn. 6 amortizes by t: the kernel's
        # steps per image and the weight volume re-touched across them
        # (every resident filter is re-applied each step its span runs)
        # — both drop as the tile grows
        steps = weight_touch = 0
        for sa, sb in zip(cuts, cuts[1:]):
            tt = max(1, min(t, net.map_shape(sb)[0]))
            n = _closure.span_schedule(net, sa, sb, out_rows=tt).n_steps
            steps += n
            weight_touch += n * net.span_weight_elems(sa, sb)
        entry = {"out_rows": t, "us_scan": round(us_t, 1),
                 "kernel_grid_steps": steps,
                 "weight_touch_elems": weight_touch}
        entry["us_cuda_kernel"] = round(timed(
            lambda: span_engine.execute_partition(params, x, net, res,
                                                  out_rows=t),
            n=3, warm=2), 1)
        sweep.append(entry)

    doc = {"device": common.device_block(dev), "vgg_mini": row,
           "res_mini": res_row, "out_rows_sweep": sweep}
    common.write_doc(common.out_path("span_engine", out_json), doc)
    return [row, res_row], derived


def stap_example():
    """§III-E worked example + simulator verification."""
    base, staged = paper_example()
    stats = simulate(staged, 400)
    rows = [{"replicas": staged.replicas,
             "throughput_closed_form": staged.throughput,
             "throughput_simulated": stats.throughput,
             "latency": stats.mean_latency}]
    return rows, stats.throughput * 20  # == 1.0 when matching paper's 1/20

"""Smoke pass over every executable benchmark family at its smallest
config, the twin of ``benchmarks/smoke.py``: one tiny net through the
span engine (residual case and out_rows sweep included), the STAP
pipeline, the serving session, the async continuous-batching engine,
the autoplan frontier, the calibrated re-scoring pass and the quantized
plans. A regression gate, not a measurement — each family must still
build, run and produce sane numbers, in seconds.

Writes nothing under ``results/`` (the measured documents come from the
real configs). Runs in-process on the device given, every mesh position
on it (``cuda:0`` by default):

    PYTHONPATH=src python -m repro_torch.benchmarks.smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from . import common


def _tiny_case(dev):
    from repro_torch.core.graph import chain
    from repro_torch.models import cnn

    C, P = "conv", "pool"
    specs = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
             (C, 3, 1, 1, 16)]
    net = chain("smoke_vgg", specs, in_h=12, in_w=12, in_ch=3)
    params = cnn.init_params(common.generator(0), net, device=dev)
    xs = common.images((4, 12, 12, 3), 1, dev)
    return net, params, xs


def smoke_span_engine(dev) -> float:
    from . import tables

    with tempfile.TemporaryDirectory() as tmp:
        rows, derived = tables.occam_span_engine(
            hw=16, reps=1, out_json=os.path.join(tmp, "span_engine.json"),
            device=dev)
    if not (rows and derived > 0):
        raise AssertionError(f"span engine: rows {rows}, derived {derived}")
    return derived


def smoke_stap(dev) -> float:
    from repro_torch import occam

    net, params, xs = _tiny_case(dev)
    plan = occam.plan(net, 2500, batch=1)
    if plan.n_spans < 2:
        raise AssertionError(f"stap: {plan.n_spans} span(s)")
    dep = plan.place(pipeline=True, microbatch=1).compile(device=dev)
    pipe = dep.pipeline(xs.shape[0])
    y = pipe.run(params, xs)
    common.block(dev)
    if y.shape[0] != xs.shape[0]:
        raise AssertionError(f"stap: output {tuple(y.shape)}")
    return float(plan.n_spans)


def smoke_serve(dev) -> float:
    from repro_torch import occam

    net, params, xs = _tiny_case(dev)
    dep = occam.plan(net, 2500, batch=1).place(
        pipeline=True, microbatch=1).compile(device=dev)
    sess = dep.serve(params)
    sess.submit(xs)
    (_t, ys), = sess.results()
    if ys.shape[0] != xs.shape[0]:
        raise AssertionError(f"serve: output {tuple(ys.shape)}")
    return float(xs.shape[0])


def smoke_autoplan(dev) -> float:
    from repro_torch import occam

    net, _params, _xs = _tiny_case(dev)
    fr = occam.autoplan(net, occam.Fleet(chips=4, vmem_elems=2500),
                        out_rows="auto")
    if not fr.candidates or not all(c.plan.out_rows >= 1 for c in fr):
        raise AssertionError("autoplan: empty frontier or bad out_rows")
    return float(len(fr.candidates))


def smoke_async(dev) -> float:
    import asyncio

    from repro_torch import occam

    net, params, xs = _tiny_case(dev)
    dep = occam.plan(net, 2500, batch=1).place(
        pipeline=True, microbatch=1).compile(device=dev)

    async def drive() -> int:
        async with occam.AsyncEngine(dep, params, max_wait_ms=20.0) as eng:
            t1 = await eng.submit(xs, tenant="a")
            t2 = await eng.submit(xs[:1], tenant="b")   # aged partial round
            y1, y2 = await t1, await t2
            if (y1.shape[0], y2.shape[0]) != (xs.shape[0], 1):
                raise AssertionError("async: output sizes")
            if eng.compile_count != 1:
                raise AssertionError(f"async: {eng.compile_count} builds")
            return eng.metrics.snapshot()["total_completions"]

    return float(asyncio.run(drive()))


def smoke_calibrate(dev) -> float:
    from repro_torch import occam

    net, params, _xs = _tiny_case(dev)
    fr = occam.autoplan(net, occam.Fleet(chips=4, vmem_elems=2500))
    dep = fr.best().deploy(device=dev)
    cm = occam.calibrate(dep, params, rounds=1)
    if not (cm.macs_per_s > 0 and cm.samples >= 1):
        raise AssertionError(f"calibrate: {cm}")
    rescored = fr.rescore(cm)
    if len(rescored) < 1 or rescored.best().plan.calibration is not cm:
        raise AssertionError("calibrate: rescored frontier")
    return float(cm.compute_overhead_factor)


def smoke_quant(dev) -> float:
    from repro_torch import occam

    net, params, xs = _tiny_case(dev)
    plans = {pol: occam.plan(net, 2500, batch=xs.shape[0], dtype_policy=pol)
             for pol in ("fp32", "int8")}
    if not plans["int8"].predicted.offchip_bytes < \
            plans["fp32"].predicted.offchip_bytes:
        raise AssertionError("quant: int8 moves no fewer bytes")
    dep = plans["int8"].place().compile(device=dev)
    y = dep.run(params, xs)
    ref = plans["fp32"].place().compile(device=dev).run(params, xs)
    if not dep.report().matches_prediction_bytes:
        raise AssertionError("quant: bytes do not match the prediction")
    return float((y - ref).abs().max())


SMOKES = [
    ("span_engine", smoke_span_engine),
    ("stap_pipeline", smoke_stap),
    ("serve_session", smoke_serve),
    ("async_engine", smoke_async),
    ("autoplan", smoke_autoplan),
    ("calibrate", smoke_calibrate),
    ("quant", smoke_quant),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where every family runs (default: cuda:0)")
    dev = common.resolve_device(ap.parse_args(argv).device)
    print("smoke,seconds,derived")
    out = {}
    for name, fn in SMOKES:
        t0 = time.perf_counter()
        out[name] = fn(dev)
        common.block(dev)
        print(f"{name},{time.perf_counter() - t0:.1f},{out[name]:.4g}")
    print("bench-smoke OK")
    return out


if __name__ == "__main__":
    main()

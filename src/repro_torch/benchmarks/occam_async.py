"""Async-engine benchmark: saturated continuous-batching throughput vs
the steady-tick prediction, plus ticket latency under Poisson arrivals;
the twin of ``benchmarks/occam_async.py``.

Where ``occam_serve`` hand-pumps a session with back-to-back submits,
this drives the same replicated deployment through
``occam.serve.AsyncEngine`` — the admission queue, round packer, staging
and asyncio loop all sit between the caller and the tick — and answers
two questions:

* **Saturation**: with the queue kept full, does engine throughput stay
  on the steady-tick prediction? Timed between ticket completions at
  steady state, paired-calibration best-of windows exactly as the serve
  benchmark.
* **Latency under load**: a Poisson arrival sweep at fractions of the
  predicted capacity; each rate reports achieved arrival rate, round
  occupancy and p50/p99 ticket latency from the engine's own metrics
  ring (fresh engine per rate — they share ONE ring build, which the
  result row records as ``engine_compile_count``).

Every mesh position sits on one device (``cuda:0`` by default),
in-process. A ticket resolves on host delivery while the device may
still compute its round, so every clock is read after a device
synchronize.

Writes ``results/BENCH_torch_async.json``:

    PYTHONPATH=src python -m repro_torch.benchmarks.occam_async [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import time

from . import common

ROUNDS_TIMED = 24   # steady-state ticket completions per timed window
PREFILL = 8         # tickets resolved before the window opens
REPS = 3
POISSON_FRACS = (0.5, 0.8)   # arrival rate as a fraction of capacity
POISSON_REQUESTS = 32


async def _saturated_window(eng, xs_round, prefill: int, rounds_timed: int,
                            dev) -> float:
    """Seconds for ``rounds_timed`` steady-state round completions:
    submit prefill+timed full-round requests back to back, then clock the
    span between the *data* of ticket ``prefill-1`` and of the last
    ticket being ready on the device. The synchronizes are the point:
    tickets resolve on host-side delivery while the device may still be
    computing, so future-resolution timestamps would measure
    bookkeeping, not device work. Completions are FIFO, so the span is
    exactly ``rounds_timed`` round exits with every stage busy."""
    tickets = [await eng.submit(xs_round)
               for _ in range(prefill + rounds_timed)]
    await tickets[prefill - 1]
    common.block(dev)
    t0 = time.perf_counter()
    await tickets[-1]
    common.block(dev)
    return time.perf_counter() - t0


async def _poisson_sweep(dep, params, xs_round, frac: float,
                         predicted_rate: float, n_requests: int,
                         dev) -> dict:
    """One Poisson arrival rate: round-sized requests at exponential
    inter-arrival gaps targeting ``frac`` of predicted capacity; report
    the engine's own metrics (achieved rate, occupancy, p50/p99)."""
    import numpy as np

    from repro_torch.occam.serve import AsyncEngine

    rb = xs_round.shape[0]
    target = frac * predicted_rate                  # images/s
    rng = np.random.default_rng(int(frac * 1000))
    gaps = rng.exponential(rb / target, n_requests)
    eng = AsyncEngine(dep, params, max_pending=1 << 20, max_wait_ms=50.0,
                      metrics_window_ms=100.0)
    arrivals = np.cumsum(gaps)          # absolute schedule: open-loop
    async with eng:                      # rate independent of service time
        t0 = time.perf_counter()
        tickets = []
        for a in arrivals:
            lead = float(a) - (time.perf_counter() - t0)
            if lead > 0:
                await asyncio.sleep(lead)
            tickets.append(await eng.submit(xs_round))
        # wait for the data, not just ticket resolution
        await asyncio.gather(*tickets)
        common.block(dev)
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        compile_count = eng.compile_count
    images = n_requests * rb
    return {
        "rate_frac": frac,
        "target_images_per_s": round(target, 1),
        "achieved_images_per_s": round(images / wall, 1),
        "round_occupancy": snap["round_occupancy"],
        "latency_p50_ms": None if snap["latency_p50_s"] is None
        else round(snap["latency_p50_s"] * 1e3, 3),
        "latency_p99_ms": None if snap["latency_p99_s"] is None
        else round(snap["latency_p99_s"] * 1e3, 3),
        "engine_compile_count": compile_count,
    }


def async_measurement(rounds_timed: int = ROUNDS_TIMED, reps: int = REPS,
                      prefill: int = PREFILL,
                      poisson_fracs=POISSON_FRACS,
                      poisson_requests: int = POISSON_REQUESTS,
                      device=None) -> dict:
    """One in-process measurement on ``device`` (default ``cuda:0``):
    the serve benchmark's replicated deployment, driven through
    ``AsyncEngine`` — saturated best-of windows against the steady-tick
    prediction, then the Poisson latency sweep. Returns the result row."""
    from repro_torch import occam
    from repro_torch.models import cnn
    from repro_torch.occam.serve import AsyncEngine

    from .audit_stamp import audit_verdict
    from .occam_stap import (CAPACITY, HW, MICROBATCH, N_DEVICES,
                             bench_case, stage_timers)

    dev = common.resolve_device(device)
    net, res = bench_case()
    params = cnn.init_params(common.generator(0), net, device=dev)
    plan = occam.plan(net, CAPACITY, batch=MICROBATCH)
    if plan.boundaries != list(res.boundaries):
        raise AssertionError(f"plan cuts {plan.boundaries}, the DP "
                             f"{list(res.boundaries)}")
    s = plan.n_spans

    unrep = plan.place(pipeline=True, microbatch=MICROBATCH).compile(
        device=dev).pipeline(8)
    solo_sampler = stage_timers(unrep, params)
    t_solo = tuple(statistics.median(ts) for ts in
                   zip(*(solo_sampler() for _ in range(3))))
    place = plan.place(chips=s + 1, stage_times=t_solo,
                       max_replicas=N_DEVICES // s, microbatch=MICROBATCH)
    steady = place.steady_schedule()
    dep = place.compile(device=dev)

    rb = place.serve_geometry(None)[0]
    xs_round = common.images((rb, HW, HW, 3), 1, dev)
    dep_sampler = stage_timers(unrep, params, replicas=place.stap.replicas)

    async def drive() -> dict:
        # max_wait_ms: the warmup's sub-round sizes (1, 3, 2*rb+1) leave
        # partial rounds that must age out — without an SLO they wait
        # for more traffic forever. Saturated windows use full rounds
        # only, so the SLO never touches the timed path.
        eng = AsyncEngine(dep, params, max_pending=1 << 20,
                          max_wait_ms=20.0, metrics_window_ms=100.0)
        async with eng:
            # warm across MIXED request sizes — the zero-new-builds
            # guarantee is part of what this benchmark records
            for size in (1, 3, rb, 2 * rb + 1):
                x = common.images((size, HW, HW, 3), 1, dev)
                await (await eng.submit(x))
            compile_count = eng.compile_count
            # paired calibration best-of, as in occam_serve: each window
            # pairs with a calibration sampled right before it,
            # closest-to-1 reported
            windows, best = [], None
            for _ in range(max(reps, 1) * 2):
                t_dep = dep_sampler()
                wall = await _saturated_window(eng, xs_round, prefill,
                                               rounds_timed, dev)
                ratio = wall / (rounds_timed * steady.steady_tick_time(t_dep))
                windows.append(ratio)
                if best is None or abs(ratio - 1) < abs(best[0] - 1):
                    best = (ratio, t_dep, wall)
                if len(windows) >= reps and abs(best[0] - 1) <= 0.25:
                    break
            overlapped = eng.packs_overlapped
            matches = bool(eng.session.report().matches_prediction)
        ratio, t_dep, wall = best
        predicted_rate = rb / steady.steady_tick_time(t_dep)
        sweep = [await _poisson_sweep(dep, params, xs_round, frac,
                                      predicted_rate, poisson_requests, dev)
                 for frac in poisson_fracs]
        images = rounds_timed * rb
        return {
            "device": common.device_block(dev),
            "audit": audit_verdict(place),
            "net": net.name, "hw": HW, "microbatch": MICROBATCH,
            "boundaries": list(res.boundaries),
            "replicas": list(place.stap.replicas),
            "chips": place.stap.chips,
            "round_batch": rb,
            "ring_depth": place.ring_depth,
            "rounds_timed": rounds_timed,
            "measurement_windows": len(windows),
            "window_ratios": [round(x, 4) for x in windows],
            "engine_compile_count": compile_count,
            "matches_prediction": matches,
            "packs_overlapped": overlapped,
            "stage_times_deployed_ms": [round(t * 1e3, 4) for t in t_dep],
            "images_per_s_measured": round(images / wall, 1),
            "images_per_s_predicted_deployed": round(
                images / (rounds_timed * steady.steady_tick_time(t_dep)), 1),
            "us_per_image_async": round(wall / images * 1e6, 1),
            "async_thr_measured_over_predicted": round(1.0 / ratio, 4),
            "poisson": sweep,
        }

    return asyncio.run(drive())


def occam_async(device=None):
    """Harness entry (``repro_torch.benchmarks.run``): measure in-process,
    write the document, and report measured/predicted saturated engine
    throughput (1.0 = exact)."""
    row = async_measurement(device=device)
    common.write_doc(common.out_path("async"), row)
    return [row], row["async_thr_measured_over_predicted"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where every mesh position runs (default: cuda:0)")
    args = ap.parse_args(argv)
    (row,), _ = occam_async(args.device)
    print(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()

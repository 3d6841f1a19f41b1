"""The formulas the metric readers share. Each takes a finished
:class:`perfbench.bench.Run` and returns a number, or None when the run
holds nothing to read (no trace, no image in the slice): a share of a
peak or a roofline is never reported as 0 for want of a reading."""
from __future__ import annotations

import math

from perfbench import work


def percentile(xs, q: float) -> float:
    """The ``q`` quantile of ``xs``, interpolated between order statistics
    as ``statistics.quantiles(method="inclusive")`` does, where an infinite
    value is allowed: a quantile that reaches one is infinite."""
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    j = math.floor(pos)
    frac = pos - j
    if frac == 0.0:
        return xs[j]
    if math.isinf(xs[j + 1]):
        return math.inf
    return xs[j] + (xs[j + 1] - xs[j]) * frac


def p95_ms(run) -> float | None:
    """The 95th percentile of every request's latency, in ms. A request
    refused or never answered misses any latency limit: it counts as
    infinitely late, so the tail is infinite once 5% of requests fail."""
    lat = list(run.latencies_s) + [math.inf] * run.failed
    if len(lat) < 20:
        return None
    return percentile(lat, 0.95) * 1e3


def images_per_s(run) -> float | None:
    return run.images_done / run.window_s if run.images_done else None


def _traced(run) -> bool:
    return run.trace is not None and run.slice is not None \
        and run.slice.images > 0


def mfu_wall(run) -> float | None:
    """FLOPs of the images answered in the slice over the slice's length
    at the peak, in %."""
    if not _traced(run):
        return None
    flops = run.slice.images * run.work.flops_per_image
    return 100.0 * flops / (run.trace.slice_s * work.PEAK_FLOPS)


def mfu_busy(run) -> float | None:
    """The same FLOPs over the time the device was busy at all (kernels or
    copies) at the peak, in %: under an open loop the wall clock is set by
    the offered load, the busy time by the system."""
    if not _traced(run) or run.trace.busy_s <= 0:
        return None
    flops = run.slice.images * run.work.flops_per_image
    return 100.0 * flops / (run.trace.busy_s * work.PEAK_FLOPS)


def conv_roofline(run) -> float | None:
    """The least time of the slice's work (operations at the peak or
    bytes at HBM speed, whichever is larger) over the device time of every
    compute kernel in the slice, in %. Copies and memsets are left out."""
    if not _traced(run) or run.trace.compute_s <= 0:
        return None
    bound = run.work.bound_s(run.slice.images, run.slice.rounds)
    return 100.0 * bound / run.trace.compute_s


def device_idle(run) -> float | None:
    """The share of the slice in which no kernel or copy ran, in %."""
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share


def kernels_per_image(run) -> float | None:
    if not _traced(run):
        return None
    return run.trace.compute_kernels / run.slice.images


def engine_occupancy(run) -> float | None:
    """Images delivered over the lanes of the rounds run, in %, from the
    engine's cumulative counters over the window."""
    eng = run.engine
    if not eng or not eng["rounds"]:
        return None
    return 100.0 * eng["completions"] / (eng["rounds"] * eng["round_batch"])


def setup(run) -> float:
    return run.setup_s

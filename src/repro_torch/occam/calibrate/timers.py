"""Wall-clock observability for the serving runtime.

Two complementary instruments:

* :class:`TickTimers` — a windowed, always-on dispatch timer the
  serving session threads through every tick; it feeds the ``timing``
  block of ``Session.report()``. Deliberately cheap: one clock read per
  tick, a bounded deque, no device synchronization.
* :func:`measure_stage_seconds` / :func:`measure_hop_seconds` —
  isolated, synchronized micro-measurements of each span stage and of a
  pipeline's boundary hop (warmed once, then timed over a loop; CUDA
  events on the GPU, the host clock on the CPU) used by
  ``occam.calibrate`` to fit a :class:`~repro_torch.occam.calibrate
  .cost_model.CostModel`.

:class:`StageProfile` is the JSON-shippable join of both: per-stage
measured seconds, boundary-hop seconds, the analytic MACs/payloads they
correspond to, and the live tick window — everything frontier
re-scoring needs, exportable alongside a plan. The classes are the
reference package's, copied unchanged.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import torch


@dataclasses.dataclass
class TickTimers:
    """Windowed wall-clock accumulator for serving ticks.

    ``record(seconds)`` stamps one completed tick; events older than
    ``horizon_s`` roll off. ``busy_fraction()`` is the fraction of the
    observed window spent inside timed ticks — the duty cycle the
    utilization stats scale per-stage shares by. A tick is timed on the
    host: on the GPU its call returns once the round is issued (a CUDA
    graph replay enqueued), so the time is the host's issue of the
    round, not the device's time computing it."""

    horizon_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    events: collections.deque = dataclasses.field(
        default_factory=collections.deque)   # (t_end, duration_s)
    total_s: float = 0.0     # lifetime, never rolls off
    count: int = 0

    def record(self, duration_s: float) -> None:
        now = self.clock()
        self.events.append((now, float(duration_s)))
        self.total_s += float(duration_s)
        self.count += 1
        self._roll(now)

    def time(self):
        """Context manager: ``with timers.time(): <one tick>``."""
        return _TimerContext(self)

    def _roll(self, now: float) -> None:
        while self.events and self.events[0][0] < now - self.horizon_s:
            self.events.popleft()

    def window(self, now: float | None = None) -> tuple[int, float]:
        """(ticks, busy seconds) inside the rolling horizon."""
        now = self.clock() if now is None else now
        self._roll(now)
        return len(self.events), sum(d for (_t, d) in self.events)

    def mean_s(self, now: float | None = None) -> float:
        n, busy = self.window(now)
        return busy / n if n else 0.0

    def busy_fraction(self, now: float | None = None) -> float:
        """Busy seconds / observed span, over the rolling window."""
        now = self.clock() if now is None else now
        n, busy = self.window(now)
        if not n:
            return 0.0
        start = self.events[0][0] - self.events[0][1]
        span = max(now - start, busy, 1e-12)
        return min(busy / span, 1.0)


class _TimerContext:
    def __init__(self, timers: TickTimers):
        self.timers = timers

    def __enter__(self):
        self._t0 = self.timers.clock()
        return self

    def __exit__(self, *exc):
        self.timers.record(self.timers.clock() - self._t0)
        return False


# --------------------------------------------------------------------------
# Isolated micro-measurements (synchronized; calibration inputs)
# --------------------------------------------------------------------------

def measure_stage_seconds(net, partition, params, *, microbatch: int = 1,
                          iters: int = 3, out_rows: int = 1,
                          routes=None,
                          clock: Callable[[], float] = time.perf_counter
                          ) -> tuple[float, ...]:
    """Measured seconds per stage body per microbatch slot.

    Each span of ``plan_span_stages(net, partition, routes=routes)`` runs
    alone through its engine on zero maps of ``(microbatch,) +
    map_shape`` for its input and each residual source crossing into it,
    on the params' device, with the spill list and per-span ``out_rows``
    clamp ``execute_partition`` uses. One warm-up call comes first (it
    builds and caches the kernel's span descriptor), then ``iters`` calls
    are timed and averaged: between two CUDA events on the current stream
    on the GPU (device time), by ``clock`` on the CPU. The result aligns
    with the MAC model ``model_stage_times`` — the (analytic, measured)
    pairs ``fit_cost_model`` regresses."""
    from repro_torch.occam import registry
    from repro_torch.runtime import stap_pipeline as sp

    stages = sp.plan_span_stages(net, partition, routes=routes)
    first = next((v for p in params for v in p.values()), None)
    device = first.device if first is not None else torch.device("cpu")
    dtype = first.dtype if first is not None else torch.float32
    iters = max(1, iters)
    times = []
    for st in stages:
        a, b = st.span
        stored = {k: torch.zeros((microbatch,) + net.map_shape(k),
                                 dtype=dtype, device=device)
                  for k in (a, *st.src_keys)}
        engine = registry.get_engine(st.route.route)
        t = max(1, min(out_rows, net.map_shape(b)[0]))

        def call():
            return engine.run(params, net, a, b, stored, st.spill,
                              out_rows=t)

        call()                                       # warm
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = clock()
            for _ in range(iters):
                call()
            times.append((clock() - t0) / iters)
    return tuple(times)


def measure_hop_seconds(ring, *, iters: int = 8,
                        clock: Callable[[], float] = time.perf_counter
                        ) -> float:
    """Measured seconds for one boundary hop of one payload slot.

    Times a chain of ``iters`` slot-level hops over the ring's own mesh
    and routing (rect or packed), each through the tick's own hop
    (``stap_pipeline._hop``: a zeroed receive buffer per position, then
    one copy per (sender, receiver) pair of slot 0's routing) in the
    ring's payload dtype, and divides out the chain length — the per-hop
    cost ``fit_cost_model`` turns into a link rate. When every position
    is on one GPU the chain is queued behind a device-side wait that
    outlasts the host's issuing of it, so the two CUDA events around the
    chain time the device's fills and copies (device-to-device copies in
    that GPU's memory), not the host's issue rate; if the device reached
    the first event before the host had issued the chain, the wait is
    lengthened and the chain timed again. Otherwise the chain is timed by
    ``clock`` after synchronizing every device, host work included.
    Returns 0.0 for single-stage rings (no links)."""
    from repro_torch.runtime.stap_pipeline import _hop

    steady = ring.steady
    if steady.n_stages == 1:
        return 0.0
    perm = ring.assignment.slot_perm(steady, 0) if ring.packing == "sum" \
        else steady.slot_perm(0)
    devs = ring.mesh.flat
    shape = (1, ring.microbatch, ring.payload_width)
    dtype = ring._payload_dtype
    x0 = [torch.zeros(shape, dtype=dtype, device=d) for d in devs]

    def chain():
        x = x0
        for _ in range(iters):
            x = _hop([[v[0]] for v in x], [perm], devs, shape, dtype)
        return x

    def sync():
        for d in set(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    chain()                                          # warm
    sync()
    t0 = clock()
    chain()
    sync()
    host_s = clock() - t0
    if not (len(set(devs)) == 1 and devs[0].type == "cuda"):
        return host_s / iters
    # the wait: 4x the host's issue-and-run time at 2 GHz, and longer
    # each time the host did not stay ahead
    cycles = max(1 << 20, int(host_s * 4 * 2e9))
    with torch.cuda.device(devs[0]):
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            chain()
            end.record()
            ahead = not start.query()
            end.synchronize()
            if ahead:
                return start.elapsed_time(end) / 1e3 / iters
            cycles *= 4
    raise RuntimeError("the host could not issue the hop chain ahead of "
                       "the device; the hop was not timed")


# --------------------------------------------------------------------------
# The JSON-shippable join
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageProfile:
    """Everything measured about a deployment's stages, exportable.

    ``stage_seconds`` come from the isolated stage bodies
    (:func:`measure_stage_seconds`); ``stage_macs`` / ``payload_elems``
    are the analytic quantities they calibrate; ``hop_seconds`` is the
    per-boundary link measurement; ``tick_*`` join the live serving
    window (:class:`TickTimers`) when the profile was taken from a
    running deployment."""

    spans: tuple[tuple[int, int], ...]
    replicas: tuple[int, ...]
    stage_macs: tuple[float, ...]
    stage_seconds: tuple[float, ...]
    payload_elems: tuple[int, ...]       # per interior boundary
    hop_seconds: float
    microbatch: int
    round_batch: int
    tick_mean_s: float = 0.0
    tick_count: int = 0
    tick_busy_fraction: float = 0.0

    def to_dict(self) -> dict:
        return {
            "spans": [list(s) for s in self.spans],
            "replicas": list(self.replicas),
            "stage_macs": list(self.stage_macs),
            "stage_seconds": list(self.stage_seconds),
            "payload_elems": list(self.payload_elems),
            "hop_seconds": self.hop_seconds,
            "microbatch": self.microbatch,
            "round_batch": self.round_batch,
            "tick_mean_s": self.tick_mean_s,
            "tick_count": self.tick_count,
            "tick_busy_fraction": self.tick_busy_fraction,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StageProfile":
        return cls(
            spans=tuple(tuple(s) for s in d["spans"]),
            replicas=tuple(d["replicas"]),
            stage_macs=tuple(d["stage_macs"]),
            stage_seconds=tuple(d["stage_seconds"]),
            payload_elems=tuple(d["payload_elems"]),
            hop_seconds=float(d["hop_seconds"]),
            microbatch=int(d["microbatch"]),
            round_batch=int(d["round_batch"]),
            tick_mean_s=float(d.get("tick_mean_s", 0.0)),
            tick_count=int(d.get("tick_count", 0)),
            tick_busy_fraction=float(d.get("tick_busy_fraction", 0.0)),
        )

"""``occam.serve.AsyncEngine`` — continuous batching over Sessions.

The vLLM-lineage split (cf. aphrodite's ``AsyncEngine`` /
``model_runner``): an asyncio front end owns request traffic — admission,
packing policy, SLOs, metrics, autoscaling — while every piece of device
work still goes through the ONE fixed-shape tick a
:class:`~repro_torch.occam.Session` wraps (``StapRing`` on pipelines, the
whole-round step on a single device, replayed from one CUDA graph on the
GPU). The engine adds **zero builds**: ``AsyncEngine.compile_count``
equals a bare session's on the same deployment, whatever the request mix.

The serving loop, per scheduling step:

1. deliver every round the ring has finished (resolve tickets, sample
   latency into the metrics windows);
2. dispatch the staged round — ONE device tick — then immediately pack
   the *next* round on the host (``torch.cat`` into pinned memory) and
   start its copy to the device (``non_blocking``) while that tick runs
   (the one-round lookahead buffer: host-side packing is double-buffered
   against device ticks, never serialized after them);
3. with no full round ready: flush an SLO-aged partial straight through
   the ring as a masked round (``Session.pump(allow_partial=True)`` —
   no drain, steady state continues), or pump one empty tick so
   resident rounds keep draining while traffic is idle.

The copy runs on the current stream, so it is ordered before the next
round's replay or ring tick without extra events. A ticket resolves
when its lanes are delivered on the host, while the device may still be
computing them: the metrics' latencies are host-delivery latencies, and
a caller timing the device synchronizes before reading its clock.

Latency SLO: ``max_wait_ms`` generalizes the session's tick-counted
``max_wait_ticks`` into wall clock — a queued partial round flushes
once its oldest request has waited that long, regardless of what other
tenants are doing (a backpressured tenant cannot starve an aged one).

Damped autoscaling: :meth:`AsyncEngine.autoscale` arms a hysteresis
controller over the metrics windows. Only when the observed arrival
rate sits outside the band around the current candidate's predicted
throughput for ``windows`` *consecutive* windows does the engine call
the existing :meth:`~repro_torch.occam.Deployment.reconcile` — fixing
the instant re-pick ``Session.scale`` does — and a switch first drains
the old ring completely, so in-flight tickets always resolve.

This is the reference package's engine with three methods of its own:
``submit`` takes numpy or a tensor and checks the images' dtype at the
front door (a dtype the session refuses would otherwise raise inside
the serving loop and leave every ticket pending), ``_stage`` packs with
``torch`` and copies to the deployment's device, and ``_deliver`` joins
a request's lanes with ``torch.cat``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

import torch

from repro_torch import convert

from ..deploy import Deployment
from .metrics import MetricsRing
from .queue import AdmissionError, AdmissionQueue, Request

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..search import Candidate, Frontier

__all__ = ["AsyncEngine", "AsyncTicket", "AdmissionError"]

# The engine drains completed rounds every scheduling step, so the
# session-level banked-round bound never binds; backpressure is the
# per-tenant admission budget at the front door instead.
_SESSION_MAX_PENDING = 1 << 30


class AsyncTicket:
    """Awaitable handle for one :meth:`AsyncEngine.submit`:
    ``y = await ticket`` yields the request's outputs in lane order.
    ``cancel()`` withdraws the request — awaiting a cancelled ticket
    raises :class:`asyncio.CancelledError`."""

    __slots__ = ("_req", "_engine")

    def __init__(self, req: Request, engine: "AsyncEngine | None" = None):
        self._req = req
        self._engine = engine

    @property
    def uid(self) -> int:
        return self._req.uid

    @property
    def tenant(self) -> str:
        return self._req.tenant

    @property
    def images(self) -> int:
        return self._req.n

    def done(self) -> bool:
        return self._req.future.done()

    def cancelled(self) -> bool:
        return self._req.cancelled

    def cancel(self) -> bool:
        """Withdraw the request. Still-queued images never pack into a
        round and stop counting toward the tenant's ``max_pending``
        budget at once; lanes already packed finish their in-flight
        rounds (the compiled tick's shape never changes) but their
        results are discarded and their budget settles as the rounds
        deliver. Returns True if the ticket was live — False when it
        had already resolved (or was already cancelled)."""
        if self._engine is None:
            return False
        return self._engine._cancel(self._req)

    def __await__(self):
        return self._req.future.__await__()

    def add_done_callback(self, fn) -> None:
        """Call ``fn(ticket)`` on the event loop once the ticket
        resolves — timing/observability hooks (e.g. completion
        timestamps) without polling ``done()``."""
        self._req.future.add_done_callback(lambda _f: fn(self))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"AsyncTicket(uid={self.uid}, tenant={self.tenant!r}, "
                f"images={self.images}, done={self.done()})")


class AsyncEngine:
    """Async continuous-batching front end over one compiled
    :class:`~repro.occam.Deployment`. See the module docstring for the
    serving loop; construct directly or via ``Frontier.serve``.

    ``max_pending`` is a **per-tenant** budget (images admitted and not
    yet delivered) — one tenant flooding gets :class:`AdmissionError`
    on its own submits while everyone else keeps flowing.
    ``max_wait_ms`` is the wall-clock latency SLO for sub-round
    traffic (default: partials wait for more traffic until ``drain``).
    ``clock`` injects a time source (tests, deterministic autoscaling).
    """

    def __init__(self, deployment: Deployment, params: Sequence[dict], *,
                 round_batch: int | None = None,
                 max_pending: int = 64,
                 max_wait_ms: float | None = None,
                 metrics_window_ms: float = 100.0,
                 metrics_windows: int = 64,
                 clock=time.monotonic):
        if max_wait_ms is not None and max_wait_ms <= 0:
            raise ValueError("max_wait_ms must be > 0 (or None to wait "
                             "for traffic indefinitely)")
        self._dep = deployment
        self._params = params
        self._round_batch_arg = round_batch
        self.max_wait_ms = max_wait_ms
        self._clock = clock
        self._session = deployment.serve(
            params, round_batch=round_batch,
            max_pending=_SESSION_MAX_PENDING)
        self.queue = AdmissionQueue(max_pending=max_pending, clock=clock)
        self.metrics = MetricsRing(window_s=metrics_window_ms / 1e3,
                                   windows=metrics_windows, clock=clock)
        # session-ticket uid -> [(request, take), ...] per dispatched round
        self._rounds: dict[int, list] = {}
        self._staged: tuple | None = None   # (xs_on_device, segs, n_valid)
        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event = asyncio.Event()
        self._stopping = False
        self._flushing = False
        # autoscale policy (armed by .autoscale())
        self._frontier: "Frontier | None" = None
        self._band = 0.25
        self._k_windows = 3
        self._streak = 0
        # observability counters
        self.packs_overlapped = 0    # rounds staged while a tick ran
        self.reconcile_calls = 0     # Deployment.reconcile() invocations
        self.switches = 0            # candidate switches actually taken

    # -- public surface ------------------------------------------------------

    @property
    def deployment(self) -> Deployment:
        return self._dep

    @property
    def session(self):
        """The session currently being pumped (changes on autoscale)."""
        return self._session

    @property
    def compile_count(self) -> int:
        """Lowerings behind the engine — equals a bare session's on the
        same deployment (the zero-new-lowerings regression signal)."""
        return self._session.compile_count

    @property
    def round_batch(self) -> int:
        return self._session.round_batch

    async def start(self) -> "AsyncEngine":
        """Start the serving loop on the running event loop (idempotent;
        ``submit`` auto-starts, ``async with engine:`` wraps
        start/stop)."""
        if self._task is None or self._task.done():
            self._stopping = False
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="occam-serve-engine")
        return self

    async def __aenter__(self) -> "AsyncEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def submit(self, images, *, tenant: str = "default"
                     ) -> AsyncTicket:
        """Admit a request of any size -> awaitable :class:`AsyncTicket`.

        Raises :class:`AdmissionError` when ``tenant`` is over its
        ``max_pending`` budget (its earlier tickets must deliver first);
        other tenants' budgets are untouched.
        """
        await self.start()
        # numpy (or anything numpy reads) lands on the host; a tensor
        # stays where it is until its round is staged
        xs = images if isinstance(images, torch.Tensor) \
            else convert.array_from_numpy(images)
        if xs.ndim == 3:
            xs = xs[None]
        shape = self._dep.plan.net.map_shape(0)
        if xs.ndim != 4 or xs.shape[0] < 1 or tuple(xs.shape[1:]) != shape:
            raise ValueError(f"submit takes (B >= 1,) + {shape} images, "
                             f"got {tuple(xs.shape)}")
        # the session's own check, here at the front door: raised inside
        # the serving loop it would stop the loop with tickets pending
        dtype = self._session._dtype
        if xs.dtype != dtype:
            raise ValueError(f"submit takes {dtype} images (the params' "
                             f"dtype), got {xs.dtype}")
        fut = asyncio.get_running_loop().create_future()
        req = self.queue.offer(tenant, xs, int(xs.shape[0]), fut)
        self.metrics.observe_arrival(req.n, self.queue.depth)
        self._wake.set()
        return AsyncTicket(req, self)

    def _cancel(self, req: Request) -> bool:
        """Cancel one admitted request (``AsyncTicket.cancel``): mask
        its queued images out of every round not yet packed, credit the
        tenant's budget for them now, and cancel the awaited future.
        In-flight lanes deliver into the void (``_deliver`` discards
        them and settles their budget share)."""
        if req.future.done():
            return False
        req.cancelled = True
        self.queue.cancel(req)
        req.future.cancel()
        self._wake.set()
        return True

    async def drain(self) -> None:
        """Flush queued partials through as masked rounds and wait until
        every admitted ticket has resolved. The engine stays open."""
        self._flushing = True
        self._wake.set()
        while not self._idle:
            await asyncio.sleep(0)

    async def stop(self) -> None:
        """Drain, stop the loop, close the session."""
        if self._task is None:
            return
        await self.drain()
        self._stopping = True
        self._wake.set()
        await self._task
        self._task = None
        self._session.close()

    def serving_stats(self) -> dict:
        """The session's queue-side counters plus a live per-stage
        ``utilization`` view.

        ``utilization[i]`` is the fraction of wall clock stage ``i``'s
        chips spent computing over the tick timer's rolling window: the
        ring's tick duty cycle scaled by the stage's share of the
        bottleneck (a stage whose per-replica time is half the
        bottleneck's idles half of every tick — exactly what
        sum-of-replicas planning trades against). Single-chip
        deployments report the one chip's duty cycle."""
        stats = dataclasses.asdict(self._session.serving_stats())
        stats["utilization"] = self._utilization()
        return stats

    def _utilization(self) -> tuple[float, ...]:
        session = self._session
        duty = session.timers.busy_fraction()
        if session._ring is None:
            return (duty,)
        plan = self._dep.placement.stap
        per_replica = [t / r for t, r in zip(plan.stage_times,
                                             plan.replicas)]
        bottleneck = max(per_replica)
        if bottleneck <= 0:
            return tuple(0.0 for _ in per_replica)
        return tuple(duty * t / bottleneck for t in per_replica)

    def describe(self) -> dict:
        """Machine-readable engine state: config, queue, metrics,
        autoscale counters, and the underlying session."""
        return {
            "round_batch": self._session.round_batch,
            "max_pending_per_tenant": self.queue.max_pending,
            "max_wait_ms": self.max_wait_ms,
            "compile_count": self.compile_count,
            "queue_depth": self.queue.depth,
            "tenants": list(self.queue.tenants),
            "rejections": self.queue.rejections,
            "cancellations": self.queue.cancellations,
            "rounds_in_flight": len(self._rounds),
            "packs_overlapped": self.packs_overlapped,
            "reconcile_calls": self.reconcile_calls,
            "switches": self.switches,
            "autoscale_armed": self._frontier is not None,
            "metrics": self.metrics.snapshot(),
            "session": self._session.describe(),
        }

    # -- autoscaling ---------------------------------------------------------

    def autoscale(self, frontier: "Frontier | None" = None, *,
                  band: float = 0.25, windows: int = 3) -> "AsyncEngine":
        """Arm damped frontier-driven autoscaling.

        Once per closed metrics window the engine compares the observed
        arrival rate against the current candidate's predicted
        throughput ``T``. The rate is *out of band* when it exceeds
        ``T`` (the candidate cannot keep up) or falls below
        ``T * (1 - band)`` (clear underload) **and** the frontier's
        pick for that rate differs from the current candidate. Only
        ``windows`` consecutive out-of-band windows trigger one
        :meth:`~repro.occam.Deployment.reconcile` — rates that merely
        hover inside the band, or spike for fewer windows, never flap
        the deployment (the damping ``Session.scale`` lacks).
        ``frontier`` defaults to the one the deployment was deployed
        from (``Candidate.deploy``).
        """
        f = frontier if frontier is not None else self._dep.frontier
        if f is None:
            raise ValueError("no frontier to autoscale against: deploy "
                             "via Candidate.deploy() or pass frontier=")
        if not 0.0 <= band < 1.0:
            raise ValueError("band must be in [0, 1)")
        if windows < 1:
            raise ValueError("windows must be >= 1")
        self._frontier = f
        self._band = band
        self._k_windows = windows
        self._streak = 0
        return self

    def autoscale_step(self, rate: float | None = None) -> bool:
        """One damped autoscale evaluation (the loop runs this per
        closed metrics window; callable directly with a synthetic
        ``rate`` for deterministic control). Returns True when a
        candidate switch happened."""
        if self._frontier is None:
            raise ValueError("autoscale(...) was never armed")
        if rate is None:
            rate = self.metrics.arrival_rate(self._k_windows)
        cur: "Candidate | None" = self._dep.candidate
        pick = self._frontier.for_rate(rate)
        if pick is cur:
            self._streak = 0
            return False
        # hysteresis band around the current candidate's throughput: a
        # differing pick only counts once the rate clearly left what the
        # current deployment serves (above it, or band-fraction below)
        if cur is not None:
            thr = cur.throughput
            if thr * (1.0 - self._band) <= rate <= thr:
                self._streak = 0
                return False
        self._streak += 1
        if self._streak < self._k_windows:
            return False
        self._streak = 0
        new = self._dep.reconcile(frontier=self._frontier,
                                  arrival_rate=rate)
        self.reconcile_calls += 1
        if new is self._dep:
            return False
        self._switch(new)
        return True

    def _switch(self, dep: Deployment) -> None:
        """Swap deployments, preserving every in-flight ticket: dispatch
        the staged round, pump the old ring dry (delivering as rounds
        exit), then open a session on the new deployment. Queued,
        not-yet-packed requests simply pack into the new geometry."""
        if self._staged is not None:
            self._dispatch(*self._staged)
            self._staged = None
        while self._rounds:
            if not self._session.pump():
                break
            self._deliver()
        self._deliver()
        self._session.close()
        self._dep = dep
        # an explicit round_batch carries over only while the new
        # geometry still divides it (same rule as Session.scale)
        round_batch = self._round_batch_arg
        if round_batch is not None:
            try:
                dep.placement.serve_geometry(round_batch)
            except ValueError:
                round_batch = None
        self._session = dep.serve(self._params, round_batch=round_batch,
                                  max_pending=_SESSION_MAX_PENDING)
        self.switches += 1

    # -- the serving loop ----------------------------------------------------

    async def _run(self) -> None:
        while True:
            now = self._clock()
            progressed = self._step(now)
            for _w in self.metrics.roll(now):
                if self._frontier is not None:
                    self.autoscale_step()
            if self._flushing and self._idle:
                self._flushing = False
            if self._stopping and self._idle:
                break
            if progressed:
                # yield so submitters run; the dispatched tick is already
                # executing asynchronously on the device
                await asyncio.sleep(0)
                continue
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       self._sleep_s(now))
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    @property
    def _idle(self) -> bool:
        return (self.queue.depth == 0 and self._staged is None
                and not self._rounds)

    def _sleep_s(self, now: float) -> float | None:
        """How long the loop may sleep: until the oldest partial's SLO
        deadline, or the next metrics-window boundary when autoscaling
        needs idle windows observed; None = until woken."""
        deadlines = []
        if self.queue.depth and self.max_wait_ms is not None:
            wait = self.queue.oldest_wait(now) or 0.0
            deadlines.append(max(self.max_wait_ms / 1e3 - wait, 0.0))
        if self._frontier is not None:
            deadlines.append(self.metrics.window_s)
        return min(deadlines) if deadlines else None

    def _aged(self, now: float) -> bool:
        if self._flushing:
            return True
        if self.max_wait_ms is None:
            return False
        wait = self.queue.oldest_wait(now)
        return wait is not None and wait * 1e3 >= self.max_wait_ms

    def _step(self, now: float) -> bool:
        """One scheduling step (see module docstring). Returns whether
        any tick ran or any round delivered."""
        progressed = self._deliver()
        rb = self._session.round_batch
        if self._staged is None and self.queue.depth >= rb:
            self._staged = self._stage(rb)
        if self._staged is not None:
            self._dispatch(*self._staged)
            self._staged = None
            progressed = True
            if self.queue.depth >= rb:
                # double-buffer: pack round t+1 while tick t runs
                self._staged = self._stage(rb)
                self.packs_overlapped += 1
        elif self.queue.depth and self._aged(now):
            # SLO flush: a masked partial round, straight through the
            # ring — steady state continues, no drain
            self._dispatch(*self._stage(min(self.queue.depth, rb)))
            progressed = True
        elif self._rounds:
            # idle traffic, resident rounds: advance the ring one tick
            if self._session.pump():
                progressed = True
        progressed = self._deliver() or progressed
        self.metrics.observe_queue_depth(self.queue.depth)
        return progressed

    def _stage(self, n: int) -> tuple:
        """Pack up to ``n`` queued images into one round buffer on the
        deployment's device (a pipeline's: its first position) — the
        lookahead buffer: the host gather and the copy to the device
        overlap the in-flight tick. Host lanes are packed into pinned
        memory and copied ``non_blocking`` on the current stream, which
        orders the copy before the round's tick."""
        taken = self.queue.take(n)
        parts = [lanes for _req, lanes, _take in taken]
        device = self._dep.device
        if device.type == "cuda" and all(p.device.type == "cpu"
                                          for p in parts):
            xs = torch.empty((sum(p.shape[0] for p in parts),)
                             + tuple(parts[0].shape[1:]),
                             dtype=parts[0].dtype, pin_memory=True)
            torch.cat(parts, out=xs)
            xs = xs.to(device, non_blocking=True)
        else:
            parts = [p.to(device) for p in parts]
            xs = parts[0] if len(parts) == 1 else torch.cat(parts)
        segs = [(req, take) for req, _lanes, take in taken]
        return xs, segs, sum(take for _req, take in segs)

    def _dispatch(self, xs, segs, n_valid: int) -> None:
        """One device tick: a full round ticks inside ``submit``; a
        partial is pumped through as a masked round."""
        ticket = self._session.submit(xs)
        if n_valid < self._session.round_batch:
            self._session.pump(allow_partial=True)
        self._rounds[ticket.uid] = segs
        self.metrics.observe_round(n_valid, self._session.round_batch)

    def _deliver(self) -> bool:
        """Collect every round the ring has finished; resolve tickets
        whose last lanes arrived and sample their latency."""
        done = self._session.results(flush=False)
        if not done:
            return False
        now = self._clock()
        for ticket, lanes in done:
            off = 0
            for req, take in self._rounds.pop(ticket.uid):
                if req.cancelled:
                    # discard the lanes; the budget share still settles
                    off += take
                    req.remaining -= take
                    self.queue.settle(req, take)
                    continue
                req.delivered.append(lanes[off:off + take])
                off += take
                req.remaining -= take
                self.queue.settle(req, take)
                if req.remaining == 0:
                    y = req.delivered[0] if len(req.delivered) == 1 \
                        else torch.cat(req.delivered)
                    self.metrics.observe_completion(req.n,
                                                    now - req.arrived)
                    if not req.future.done():
                        req.future.set_result(y)
        return True

"""Stages 3-4 of the deployment API: ``Placement.compile`` ->
:class:`Deployment` -> ``run`` / ``serve`` / ``report``.

Compiling binds the placement to engines through the registry: under
``backend="auto"`` each span keeps the route the planner picked; a forced
backend re-routes every span onto one engine (or raises
:class:`~repro_torch.occam.registry.BackendError` if a span is ineligible
— never a silent substitution).

* Single-device deployments execute through
  ``repro_torch.runtime.span_engine.execute_partition`` on the
  deployment's device, under the plan's dtype policy.
* Pipeline deployments build (and cache, per stream batch size) a
  ``repro_torch.runtime.stap_pipeline.StapPipeline`` over the placement's
  :class:`~repro_torch.core.stap.StapPlan`, its positions on the
  deployment's devices (one device may hold them all). Stage bodies
  dispatch through the registry's ``make_spmd_body`` builders:
  kernel-routed spans launch the CUDA fused-span kernel on a GPU
  position — no scan substitution. Only the ``interpreted`` specification
  is rejected on pipeline placements (it has no stage body).

Serving is a first-class surface, not a loop over ``run``:
``Deployment.serve()`` opens a :class:`Session` — a long-lived stream of
requests flowing through ONE fixed round shape. ``Session.submit`` packs
ragged traffic into fixed ``round_batch`` rounds (zero-padded masked
lanes fill the final partial round; they skip compute in a pipeline, are
dropped from outputs and are excluded from measured traffic), so mixed
submit sizes never rebuild the step. On the GPU a single-device step is
one CUDA graph per ``round_batch``, captured when the first session at
that size opens and replayed for every round. Pipeline sessions iterate a
single-tick :class:`~repro_torch.runtime.stap_pipeline.StapRing` whose
per-position buffers are O(round_batch) regardless of stream length.
``Session.pump`` exposes single-tick advancement to external drivers.
A deployment made by ``Candidate.deploy`` knows its planning frontier:
``Deployment.reconcile`` and ``Session.scale`` re-pick from it for an
arrival rate without re-running the DP, and ``Deployment.profile``
measures its stages for ``occam.calibrate``.

Every ``run`` accumulates off-chip transfers into one
:class:`~repro_torch.core.traffic.TrafficCounter`; ``report()`` returns
the plan's predicted per-image :class:`~repro_torch.core.traffic
.TrafficReport` with the measurement attached — model vs machine in one
object (sessions carry their own, masked-lane-exact, measurement:
``Session.report``).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.traffic import TrafficCounter, TrafficReport
from repro_torch.kernels.fused_span import kernel as span_kernel
from repro_torch.models import cnn
from repro_torch.runtime import span_engine

from . import registry, trace
from .calibrate.timers import TickTimers
from .place import PIPELINE, SINGLE, Placement
from .quant import casting

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.runtime.stap_pipeline import StapPipeline, StapRing

    from .calibrate.timers import StageProfile
    from .search import Candidate, Frontier


class Deployment:
    """A compiled, runnable placement. Build via ``Placement.compile``."""

    def __init__(self, placement: Placement, backend: str = registry.AUTO,
                 *, device: torch.device | None = None,
                 devices: tuple[torch.device, ...] | None = None):
        if backend != registry.AUTO:
            spec = registry.get_engine(backend)  # unknown names fail here
            if placement.kind == PIPELINE and not spec.spmd_capable:
                spmd = [registry.AUTO] + [e.name for e in
                                          registry.registered_engines()
                                          if e.spmd_capable]
                raise registry.BackendError(
                    f"backend {backend!r} cannot drive a pipeline "
                    f"placement (it has no stage body; its EngineSpec is "
                    f"not spmd_capable — choose one of {spmd})")
        self.placement = placement
        self.plan = placement.plan
        self.backend = backend
        # a pipeline's mesh positions go on ``devices`` (repeats allowed);
        # inputs land on, and outputs come back from, the first of them
        self.devices = devices
        self.device = devices[0] if placement.kind == PIPELINE else device
        self.mesh = None
        if placement.kind == PIPELINE:
            from repro_torch.runtime import stap_pipeline as sp

            # the serving ring's mesh, built here so that a short or mixed
            # device list fails at compile time
            stap = placement.stap
            self.mesh = sp.packed_mesh(stap.chips, devices) \
                if placement.packing == "sum" else \
                sp.stap_mesh(len(stap.replicas), max(stap.replicas), devices)
        # forced backends re-route at compile time; BackendError surfaces
        # any span the engine cannot take. The policy's compute dtype
        # picks the routes (int8 boundaries dequantize at span entry)
        quant = self.plan.quant
        self.routes = self.plan.routes if backend == registry.AUTO else \
            span_engine.plan_routes(self.plan.net, self.plan.partition,
                                    backend=backend,
                                    out_rows=self.plan.out_rows,
                                    dtype=quant.compute if quant else None)
        self.counter = TrafficCounter()
        self._images = 0
        # set by Candidate.deploy: where this deployment sits on a
        # planning frontier (drives reconcile / Session.scale)
        self.candidate: "Candidate | None" = None
        self.frontier: "Frontier | None" = None
        self._pipes: dict[int, "StapPipeline"] = {}
        self._rings: dict[int, "StapRing"] = {}
        # single-device serving steps, one per round_batch
        self._steps: dict[int, _RoundStep] = {}
        self._per_image_cache: TrafficCounter | None = None

    @property
    def kind(self) -> str:
        return self.placement.kind

    def pipeline(self, batch: int) -> "StapPipeline":
        """The STAP pipeline for streams of ``batch`` images (cached —
        repeated ``run`` calls at one batch size reuse its stage bodies
        and position params)."""
        from repro_torch.runtime.stap_pipeline import StapPipeline

        if self.kind != PIPELINE:
            raise ValueError("single-device deployment has no pipeline; "
                             "use .run directly")
        pipe = self._pipes.get(batch)
        if pipe is None:
            # the batch program is rectangular whatever the ring's packing
            reps = self.placement.stap.replicas
            rect = len(reps) * max(reps)
            if len(self.devices) < rect:
                raise ValueError(
                    f"run() executes the rectangular batch program, whose "
                    f"mesh has {rect} positions; this sum-packed "
                    f"deployment was compiled on {len(self.devices)} "
                    f"devices, enough for serve() only. Compile it with "
                    f"device= (every position on one device) or devices= "
                    f"a list of {rect} to run it")
            pipe = StapPipeline(
                self.plan.net, self.plan.partition, batch,
                self.placement.microbatch, plan=self.placement.stap,
                mesh=self.mesh if self.placement.packing == "rect" else None,
                devices=self.devices, routes=self.routes,
                out_rows=self.plan.out_rows, policy=self.plan.quant)
            self._pipes[batch] = pipe
        return pipe

    def ring(self, microbatch: int) -> "StapRing":
        """The single-tick serving ring for ``microbatch`` images per slot
        (cached — every session at one round geometry shares ONE tick
        build)."""
        from repro_torch.runtime.stap_pipeline import StapRing

        if self.kind != PIPELINE:
            raise ValueError("single-device deployment has no serving "
                             "ring; serve() runs whole rounds per tick")
        ring = self._rings.get(microbatch)
        if ring is None:
            ring = StapRing(
                self.plan.net, self.plan.partition, microbatch,
                plan=self.placement.stap, mesh=self.mesh,
                routes=self.routes, out_rows=self.plan.out_rows,
                packing=self.placement.packing, policy=self.plan.quant)
            self._rings[microbatch] = ring
        return ring

    def run(self, params: Sequence[dict], xs,
            counter: TrafficCounter | None = None) -> torch.Tensor:
        """Execute one batch ((B, H, W, C), or one (H, W, C) image on a
        single device) on the deployment's device(s); a pipeline's output
        comes back on its first device. ``params`` and ``xs`` may be numpy
        arrays or tensors anywhere; they move to the devices first.
        ``counter``, if given, also receives this call's transfers (the
        deployment always accumulates its own)."""
        xs = convert.array_from_numpy(xs, self.device)
        r0, w0 = self.counter.reads, self.counter.writes
        rb0, wb0 = self.counter.read_bytes, self.counter.write_bytes
        if self.kind == SINGLE:
            y = span_engine.execute_partition(
                convert.params_from_numpy(params, self.device), xs,
                self.plan.net, self.plan.partition, counter=self.counter,
                routes=self.routes, out_rows=self.plan.out_rows,
                policy=self.plan.quant)
            self._images += xs.shape[0] if xs.ndim == 4 else 1
        else:
            if xs.ndim != 4:
                raise ValueError("pipeline deployments stream batched "
                                 "(B, H, W, C)")
            y = self.pipeline(xs.shape[0]).run(params, xs,
                                               counter=self.counter)
            self._images += xs.shape[0]
        if counter is not None:
            counter.reads += self.counter.reads - r0
            counter.writes += self.counter.writes - w0
            counter.read_bytes += self.counter.read_bytes - rb0
            counter.write_bytes += self.counter.write_bytes - wb0
        return y

    def _per_image_profile(self) -> TrafficCounter:
        """Per-image transfer profile of this deployment's spans (cached —
        a pure function of the deployment; sessions scale it by their
        valid lanes for masked-lane accounting)."""
        if self._per_image_cache is None:
            quant = self.plan.quant
            bpe = quant.boundary_bytes if quant is not None else 4.0
            per = TrafficCounter()
            net, boundaries = self.plan.net, self.plan.boundaries
            for r in self.routes:
                spill = span_engine.span_spills(net, boundaries, r.start,
                                                r.end)
                cnn.count_span_reads(per, net, r.start, r.end, 1,
                                     bytes_per_elem=bpe)
                cnn.count_span_writes(per, net, r.end, spill, 1,
                                      bytes_per_elem=bpe)
            self._per_image_cache = per
        return self._per_image_cache

    def _serve_step(self, round_batch: int) -> "_RoundStep":
        """The serving step at the fixed (round_batch, H, W, C) shape,
        cached per round_batch so every session at one geometry shares
        one build (``builds`` is the one-compile regression signal)."""
        step = self._steps.get(round_batch)
        if step is None:
            step = self._steps[round_batch] = _RoundStep(self, round_batch)
        return step

    def serve(self, params: Sequence[dict], *,
              round_batch: int | None = None,
              max_pending: int = 16,
              max_wait_ticks: int | None = None) -> "Session":
        """Open a continuous serving session (the steady-state surface).

        ``round_batch``: images per round — the ONE fixed shape every
        request is packed into (default: the plan's recorded serving
        default, else the placement microbatch). Mixed ``submit`` sizes
        all serve from a single step build; the final partial round of a
        flush is padded with masked lanes that are dropped from outputs
        and excluded from measured traffic. ``max_pending``: completed
        rounds the session buffers before ``submit`` demands a
        ``results()`` drain (host-side backpressure). ``max_wait_ticks``:
        latency budget for sub-round traffic — a queued partial round
        auto-flushes once it has waited this many *subsequent* session
        ticks (``submit``/``ready`` calls; the submit that starts the
        partial doesn't count, so later traffic always gets a chance to
        batch into it) without filling (default: wait indefinitely).

        The params are converted to the device and quantized under the
        plan's policy once, here. On the GPU the first session at a
        ``round_batch`` captures the step's CUDA graph here too; a failed
        capture raises — there is no eager fallback on the GPU.
        """
        serving = self.plan.serving
        if (self.kind == PIPELINE and serving.ring_depth is not None
                and serving.ring_depth != self.placement.ring_depth):
            raise ValueError(
                f"plan records serving.ring_depth {serving.ring_depth} "
                f"but this placement's ring is "
                f"{self.placement.ring_depth} rounds deep (one per "
                f"pipeline stage, {len(self.placement.replicas)} "
                f"stages); the plan document is stale or corrupted — "
                f"re-plan, or fix the serving block")
        # raises the serve_geometry ValueError here, with the offending
        # round_batch named
        self.placement.serve_geometry(round_batch)
        return Session(self, params, round_batch=round_batch,
                       max_pending=max_pending,
                       max_wait_ticks=max_wait_ticks)

    def reconcile(self, frontier: "Frontier | None" = None, *,
                  arrival_rate: float) -> "Deployment":
        """Serve-time autoscaling: the deployment for the cheapest
        frontier candidate meeting ``arrival_rate`` (images/s).

        Returns ``self`` when this deployment's own candidate is already
        the pick; otherwise the chosen candidate's (cached) deployment on
        this deployment's backend and device (a pipeline's first device,
        which then hosts every position of a pipeline pick) — compiled
        placements are reused per candidate, and the DP never re-runs (the
        frontier already holds every plan). ``frontier`` defaults to the
        one this deployment was deployed from (``Candidate.deploy``).
        """
        f = frontier if frontier is not None else self.frontier
        if f is None:
            raise ValueError(
                "no frontier to reconcile against: deploy via "
                "occam.autoplan(...) -> Candidate.deploy(), or pass "
                "frontier=")
        cand = f.for_rate(arrival_rate)
        if self.candidate is not None and cand is self.candidate:
            return self
        return cand.deploy(self.backend, device=self.device)

    def profile(self, params: Sequence[dict], *,
                iters: int = 3) -> "StageProfile":
        """Measure this deployment's stages in isolation -> a
        JSON-shippable ``occam.calibrate.StageProfile``.

        Each span stage runs alone through its engine on the deployment's
        (first) device at the placement's microbatch, warmed once and
        timed over ``iters`` calls (CUDA events on the GPU). A pipeline
        deployment also times one boundary hop over its serving ring's own
        mesh and routing (``measure_hop_seconds``: on one GPU a
        device-to-device copy in its memory), and joins the live tick
        window of the busiest serving ring built so far (zeros when
        nothing has served yet). A single-device placement has no hop
        (``hop_seconds`` 0.0), and its sessions keep their tick timers
        themselves. ``occam.calibrate(deployment, params)`` fits a
        ``CostModel`` from the result.
        """
        from repro_torch.runtime.stap_pipeline import (model_stage_times,
                                                       plan_span_stages)

        from .calibrate.timers import (StageProfile, measure_hop_seconds,
                                       measure_stage_seconds)

        plan = self.plan
        stages = plan_span_stages(plan.net, plan.partition,
                                  routes=self.routes)
        stage_macs = model_stage_times(plan.net, stages)
        payload_elems = tuple(int(st.out_spec.elems)
                              for st in stages[:-1])
        microbatch = self.placement.microbatch
        params = casting.quantize_params(
            convert.params_from_numpy(params, self.device), plan.quant)
        stage_seconds = measure_stage_seconds(
            plan.net, plan.partition, params, microbatch=microbatch,
            iters=iters, out_rows=plan.out_rows, routes=self.routes)
        hop = 0.0
        if self.kind == PIPELINE and len(stages) > 1:
            hop = measure_hop_seconds(self.ring(microbatch))
        round_batch, _mb = self.placement.serve_geometry(None)
        timing = self._timing() or {}
        return StageProfile(
            spans=tuple(tuple(st.span) for st in stages),
            replicas=tuple(self.placement.replicas),
            stage_macs=tuple(float(m) for m in stage_macs),
            stage_seconds=stage_seconds,
            payload_elems=payload_elems,
            hop_seconds=hop,
            microbatch=microbatch,
            round_batch=round_batch,
            tick_mean_s=timing.get("tick_mean_s", 0.0),
            tick_count=timing.get("tick_count", 0),
            tick_busy_fraction=timing.get("tick_busy_fraction", 0.0))

    def _timing(self) -> dict | None:
        """Live tick-window stats from the busiest serving ring (None
        when no ring has timed a tick)."""
        rings = [r for r in self._rings.values() if r.timers.count]
        if not rings:
            return None
        t = max(rings, key=lambda r: r.timers.count).timers
        return {"tick_mean_s": t.mean_s(), "tick_count": t.count,
                "tick_busy_fraction": t.busy_fraction()}

    def report(self) -> TrafficReport:
        """Predicted and measured traffic in one object (per-image
        prediction + everything counted since compile), with the live
        tick-timing window of a pipeline's serving rings attached as
        ``report.timing`` once serving has run."""
        rep = self.plan.predicted.with_measured(self.counter, self._images)
        return dataclasses.replace(rep, timing=self._timing())

    def describe(self) -> dict:
        """Machine-readable deployment configuration (benchmarks, logs)."""
        d = {
            "kind": self.kind,
            "backend": self.backend,
            "device": str(self.device),
            "boundaries": self.plan.boundaries,
            "routes": [[r.start, r.end, r.route] for r in self.routes],
            "batch": self.plan.batch,
            "capacity_elems": self.plan.capacity_elems,
            "predicted_transfers_per_image": self.plan.predicted_transfers,
            "images_run": self._images,
            "measured_transfers": self.counter.total,
            "measured_bytes": self.counter.total_bytes,
            "quant": (self.plan.quant.to_dict()
                      if self.plan.quant is not None else None),
        }
        if self.kind == PIPELINE:
            d["replicas"] = list(self.placement.replicas)
            d["chips"] = self.placement.chips
            d["microbatch"] = self.placement.microbatch
            pipes = {b: p.report() for b, p in self._pipes.items()}
            if pipes:
                d["pipelines"] = pipes
            rings = {r.round_batch: r.report()
                     for r in self._rings.values()}
            if rings:
                d["rings"] = rings
        return d


class _RoundStep:
    """One whole-round execution at the fixed (round_batch, H, W, C)
    shape, built once per (deployment, round_batch).

    On the CPU it runs ``execute_partition`` eagerly. On the GPU ``build``
    captures it into a ``torch.cuda.CUDAGraph`` over static tensors: a
    round is copied (zero-padded) into the static input, the graph
    replays, and the static output is cloned out. The capture is preceded
    by one warm-up call on a side stream, which builds and caches each
    span's descriptor (a host-to-device copy, illegal inside a capture).
    The params are static too: a session whose params are not the ones
    last bound copies them into the step's buffers before its replay.

    A replay launches the kernels without passing through their
    wrappers, so the step adds to the fused-span kernel's ``counts`` what
    the capture recorded (``per_replay``, a ``Counts`` record: the
    launches, and per image of the round the rows, barriers and weight
    bytes), once per replay.
    """

    def __init__(self, deployment: Deployment, round_batch: int):
        self.deployment = deployment
        self.round_batch = round_batch
        self.builds = 0
        self.per_replay = span_kernel.Counts()
        self.graph: torch.cuda.CUDAGraph | None = None
        self._params: list[dict] | None = None
        self._bound = None
        self._x: torch.Tensor | None = None
        self._y: torch.Tensor | None = None

    def _execute(self, params, xs) -> torch.Tensor:
        dep = self.deployment
        plan = dep.plan
        return span_engine.execute_partition(
            params, xs, plan.net, plan.partition, counter=None,
            routes=dep.routes, out_rows=plan.out_rows, policy=plan.quant)

    def build(self, params: list[dict], dtype: torch.dtype) -> None:
        """Build the step once (capture on the GPU); later calls no-op."""
        if self.builds:
            return
        device = self.deployment.device
        if device.type == "cuda":
            self._capture(params, dtype, device)
        self.builds += 1

    def _capture(self, params, dtype, device) -> None:
        shape = (self.round_batch,) + self.deployment.plan.net.map_shape(0)
        self._params = [{k: v.clone() for k, v in p.items()} for p in params]
        self._bound = params
        self._x = torch.zeros(shape, dtype=dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._execute(self._params, self._x)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = span_kernel.counts.copy()
        # a dead step's graph, freed by the cyclic garbage collector in
        # the middle of this capture, would invalidate it (destroying a
        # graph is illegal while a stream captures): collect first, then
        # hold the collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._y = self._execute(self._params, self._x)
        except Exception as e:
            raise RuntimeError(
                f"capturing the serving round (round_batch "
                f"{self.round_batch}) into a CUDA graph failed; serve() "
                f"does not fall back to eager execution on the GPU") from e
        finally:
            if collecting:
                gc.enable()
            # a capture records launches, it makes none
            self.per_replay = span_kernel.counts - before
            span_kernel.counts.reset(before)
        self.graph = graph

    def __call__(self, params: list[dict], xs: torch.Tensor) -> torch.Tensor:
        """Outputs of all ``round_batch`` lanes for ``xs``, which holds the
        round's first ``len(xs)`` images; the rest are zero lanes."""
        n = xs.shape[0]
        if self.graph is None:
            if n < self.round_batch:
                xs = torch.cat([xs, xs.new_zeros(
                    (self.round_batch - n,) + tuple(xs.shape[1:]))])
            return self._execute(params, xs)
        if params is not self._bound:
            for dst, src in zip(self._params, params):
                for k, v in dst.items():
                    v.copy_(src[k])
            self._bound = params
        self._x[:n].copy_(xs)
        self._x[n:].zero_()
        self.graph.replay()
        span_kernel.counts.add(self.per_replay)
        return self._y.clone()


# --------------------------------------------------------------------------
# Continuous serving sessions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingStats:
    """Queue-side serving state of one :class:`Session`. Attached to
    ``Session.report()`` as ``report.serving`` and inlined into
    ``Session.describe()``."""

    pending_lanes: int       # images queued, not yet packed into a round
    in_flight_rounds: int    # rounds resident in the ring right now
    rounds_served: int       # ticks that carried >= 1 valid lane
    flush_count: int         # explicit / SLO-triggered drains
    waited_ticks: int        # total ticks queued partials spent aging


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Handle for one ``Session.submit`` call: ``uid`` orders results
    (submit order is result order), ``images`` is the submit size."""

    uid: int
    images: int


class _TicketState:
    __slots__ = ("ticket", "chunks", "remaining")

    def __init__(self, ticket: Ticket):
        self.ticket = ticket
        self.chunks: list[torch.Tensor] = []  # output lanes, round by round
        self.remaining = ticket.images

    @property
    def done(self) -> bool:
        return self.remaining == 0

    def result(self) -> torch.Tensor:
        return self.chunks[0] if len(self.chunks) == 1 \
            else torch.cat(self.chunks)


class Session:
    """A continuous serving session: requests of any size flow through
    ONE fixed round shape. Build via :meth:`Deployment.serve`.

    ``submit(images) -> Ticket`` enqueues a request; the session packs
    the queue into fixed ``round_batch`` rounds and runs each as soon as
    it is full. ``results()`` flushes — the final partial round is padded
    with *masked* lanes (they never appear in outputs and are excluded
    from measured traffic) — then returns every completed ``(ticket,
    outputs)`` pair in submit order. ``ready()`` peeks at completed
    tickets without flushing (results stay collectable).

    One step build serves every submit size (``compile_count`` is the
    regression signal). ``report()`` attaches the session's
    masked-lane-exact measurement to the plan's per-image prediction —
    ``matches_prediction`` holds under any mix of submit sizes. A
    single-device round completes within its tick (ring depth 1); a
    pipeline session iterates a single-tick
    :class:`~repro_torch.runtime.stap_pipeline.StapRing`, so a round
    leaves the ring ``ring_depth - 1`` ticks after it entered, and masked
    slots skip their span bodies.
    """

    def __init__(self, deployment: Deployment, params: Sequence[dict], *,
                 round_batch: int | None = None, max_pending: int = 16,
                 max_wait_ticks: int | None = None):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if max_wait_ticks is not None and max_wait_ticks < 1:
            raise ValueError("max_wait_ticks must be >= 1 (or None to "
                             "wait indefinitely)")
        self.deployment = deployment
        self.max_wait_ticks = max_wait_ticks
        self._waited = 0            # session ticks the queued partial aged
        placement = deployment.placement
        self.round_batch, self.microbatch = \
            placement.serve_geometry(round_batch)
        self.ring_depth = placement.ring_depth
        self.max_pending = max_pending
        # on the device, as given (what scale() hands over), and under
        # the plan's weight dtype, once (a pipeline's ring quantizes them
        # itself, once per position device)
        self._given_params = convert.params_from_numpy(params,
                                                       deployment.device)
        self.params = params = self._given_params \
            if deployment.kind == PIPELINE else casting.quantize_params(
                self._given_params, deployment.plan.quant)
        # the round's activation dtype: the params' (fp32 under every
        # policy; the casts keep it)
        self._dtype = next((v.dtype for p in params for v in p.values()),
                           torch.float32)
        if deployment.kind == PIPELINE:
            self._step = None
            self._ring = ring = deployment.ring(self.microbatch)
            self.ring_depth = ring.ring_depth
            # pipeline sessions share the ring's tick timer (every
            # session at one geometry drives the same tick build)
            self.timers = ring.timers
            self._state = ring.init_state()
            # the all-masked drain round, in the ring's payload dtype
            # (a quantized ring carries e.g. int8 slots)
            self._empty_round = torch.zeros(
                (ring.round_width, self.microbatch, ring.payload_width),
                dtype=ring._payload_dtype, device=deployment.device)
            self._masks = [np.zeros(ring.round_width, dtype=bool)
                           for _ in range(self.ring_depth)]
        else:
            self._ring = None
            self._state = None
            self.timers = TickTimers()
            self._step = deployment._serve_step(self.round_batch)
            self._step.build(self.params, self._dtype)
        # per-image transfer profile for masked-lane accounting: sessions
        # count per_image x valid lanes, never per_span x round size
        self._per_image = deployment._per_image_profile()
        self.counter = TrafficCounter()
        self._images = 0            # valid images entered (masked excluded)
        self._next_uid = 0
        self._tickets: dict[int, _TicketState] = {}
        self._queue: collections.deque = collections.deque()  # [uid, xs, off]
        self._queued = 0
        # rounds resident in the ring, oldest last: segment lists or None
        self._in_flight: collections.deque = collections.deque(
            [None] * (self.ring_depth - 1))
        self._banked_rounds = 0     # completed, not yet results()-collected
        self._closed = False
        # queue-side counters (surfaced via describe()/report().serving)
        self._flushes = 0           # explicit / SLO-triggered drains
        self._rounds_served = 0     # ticks that carried >= 1 valid lane
        self._waited_total = 0      # total ticks partials spent aging

    # -- the serving surface ------------------------------------------------

    def submit(self, images) -> Ticket:
        """Enqueue a request of any size -> :class:`Ticket`.

        ``images``: (B, H, W, C) or a single (H, W, C) image, as numpy or
        a tensor anywhere, in the params' dtype. Full rounds run
        immediately; a trailing remainder waits for more traffic (flush
        it with ``results()``).
        """
        if self._closed:
            raise RuntimeError("session is closed")
        with trace.span("occam.session.submit") as sp:
            had_partial = self._queued > 0
            xs = convert.array_from_numpy(images, self.deployment.device)
            if xs.ndim == 3:
                xs = xs[None]
            want = self.deployment.plan.net.map_shape(0)
            if xs.ndim != 4 or xs.shape[0] < 1 or \
                    tuple(xs.shape[1:]) != want:
                raise ValueError(f"submit takes (B >= 1,) + {want} images, "
                                 f"got {tuple(xs.shape)}")
            if xs.dtype != self._dtype:
                raise ValueError(f"submit takes {self._dtype} images (the "
                                 f"params' dtype), got {xs.dtype}")
            ticket = Ticket(self._next_uid, int(xs.shape[0]))
            if sp:
                sp.set(ticket=ticket.uid, images=ticket.images)
            self._next_uid += 1
            self._tickets[ticket.uid] = _TicketState(ticket)
            self._queue.append([ticket.uid, xs, 0])
            self._queued += ticket.images
            while self._queued >= self.round_batch:
                # backpressure BEFORE popping the round: a refused submit
                # leaves the queue intact, so results() still serves it
                self._check_pending()
                self._tick(*self._take_round())
            # age only a PRE-EXISTING partial: the submit that starts (or
            # extends) a fresh remainder must give later traffic at least
            # one tick to fill it, or max_wait_ticks=1 would degenerate to
            # flush-per-submit with no cross-submit batching ever
            if had_partial:
                self._age_partial()
        return ticket

    def ready(self) -> tuple[Ticket, ...]:
        """Tickets whose results are complete right now, in submit order.
        Never flushes on demand — but under a ``max_wait_ticks`` budget
        each call ages the queued partial round one tick, so polling
        eventually pushes a lone sub-round submit through."""
        self._age_partial()
        return tuple(ts.ticket for ts in self._tickets.values() if ts.done)

    def results(self, *, flush: bool = True
                ) -> list[tuple[Ticket, torch.Tensor]]:
        """Collect completed requests in submit order.

        ``flush=True`` (default) first packs any queued remainder into a
        masked partial round and drains the ring, so every outstanding
        ticket completes; ``flush=False`` returns only what full rounds
        already finished.
        Collected tickets leave the session.
        """
        if flush:
            self.flush()
        out = []
        for uid in list(self._tickets):
            ts = self._tickets[uid]
            if ts.done:
                out.append((ts.ticket, ts.result()))
                del self._tickets[uid]
        # recompute the backpressure gauge from what actually remains
        # buffered: each chunk on an open ticket is one delivered round
        # segment still held (a conservative, upper-bound round count)
        self._banked_rounds = sum(len(ts.chunks)
                                  for ts in self._tickets.values())
        return out

    def flush(self) -> None:
        """Push the queued remainder through as a masked partial round
        and run drain ticks until the ring holds no live rounds. The
        session stays open — steady-state serving resumes on the next
        ``submit``."""
        self._flushes += 1
        while self._queued:     # full rounds a refused submit left behind,
            self._tick(*self._take_round())   # then the masked partial one
        while self.in_flight_rounds:
            self._tick(None, None)
        self._waited = 0

    def pump(self, *, allow_partial: bool = False) -> bool:
        """Advance the session by exactly ONE tick — the external-pumping
        hook async drivers build on.

        A queued full round ticks first. Otherwise, with
        ``allow_partial=True``, a queued remainder ticks through as one
        masked partial round — unlike :meth:`flush`, the ring is NOT
        drained. Otherwise a round resident in a pipeline's ring advances
        one empty tick toward delivery. Returns whether a tick ran (False
        = nothing to do: idle queue, empty ring).
        """
        if self._closed:
            raise RuntimeError("session is closed")
        if self._queued >= self.round_batch:
            self._check_pending()
            self._tick(*self._take_round())
            return True
        if allow_partial and self._queued:
            self._tick(*self._take_round())
            self._waited = 0
            return True
        if self.in_flight_rounds:
            self._tick(None, None)
            return True
        return False

    def sync(self) -> "Session":
        """Block until every dispatched round has finished (rounds
        dispatch asynchronously on the GPU — time steady-state
        throughput against this)."""
        for dev in set(self.deployment.devices or (self.deployment.device,)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def scale(self, *, arrival_rate: float) -> "Session":
        """Serve-time autoscaling: re-pick the deployment for an observed
        ``arrival_rate`` (images/s) from the planning frontier.

        Returns ``self`` when the current deployment already is the
        cheapest candidate meeting the rate. Otherwise the session is
        flushed (outstanding tickets complete and stay collectable via
        ``results()`` here) and a NEW session on the chosen candidate's
        cached deployment is returned — submit new traffic there. The
        frontier is reused as-is: no DP, no search, and candidates the
        session scaled through before keep their deployments and their
        captured steps. This session's ``round_batch`` carries over when
        the new placement accepts it; otherwise the new session falls
        back to the candidate's own geometry default. The new session
        gets the params this one was given, and quantizes them under its
        own plan's policy.
        """
        dep = self.deployment.reconcile(arrival_rate=arrival_rate)
        if dep is self.deployment:
            return self
        self.flush()
        try:
            dep.placement.serve_geometry(self.round_batch)
            round_batch = self.round_batch
        except ValueError:
            round_batch = None
        return dep.serve(self._given_params, round_batch=round_batch,
                         max_pending=self.max_pending,
                         max_wait_ticks=self.max_wait_ticks)

    def close(self) -> list[tuple[Ticket, torch.Tensor]]:
        """Flush, collect the final results, and end the session."""
        if self._closed:
            return []
        out = self.results()
        self._closed = True
        self._state = None
        return out

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting ----------------------------------------------------------

    @property
    def compile_count(self) -> int:
        """Step builds behind this session (CUDA-graph captures of a
        single-device step on the GPU, builds of a pipeline's ring tick)
        — 1 however submit sizes mix."""
        if self._ring is not None:
            return self._ring.trace_count
        return self._step.builds

    @property
    def in_flight_rounds(self) -> int:
        """Rounds resident in a pipeline's ring (dispatched, not yet
        delivered); a single-device round is delivered by the tick that
        runs it."""
        return sum(1 for m in self._in_flight if m is not None)

    def serving_stats(self) -> ServingStats:
        """The queue-side state an async engine's metrics sample."""
        return ServingStats(
            pending_lanes=self._queued,
            in_flight_rounds=self.in_flight_rounds,
            rounds_served=self._rounds_served,
            flush_count=self._flushes,
            waited_ticks=self._waited_total)

    def report(self) -> TrafficReport:
        """The plan's per-image prediction with this session's measured
        transfers attached (masked padding lanes excluded from both
        ``measured_*`` and ``images``, so ``matches_prediction`` holds
        under any mix of submit sizes), the queue-side serving state as
        ``report.serving``, and the tick-timing window as
        ``report.timing``."""
        rep = self.deployment.plan.predicted.with_measured(
            self.counter, self._images)
        timing = None
        if self.timers.count:
            timing = {"tick_mean_s": self.timers.mean_s(),
                      "tick_count": self.timers.count,
                      "tick_busy_fraction": self.timers.busy_fraction()}
        return dataclasses.replace(rep, serving=self.serving_stats(),
                                   timing=timing)

    def describe(self) -> dict:
        """Machine-readable session state (benchmarks, logs)."""
        d = {
            "kind": self.deployment.kind,
            "round_batch": self.round_batch,
            "microbatch": self.microbatch,
            "ring_depth": self.ring_depth,
            "max_pending": self.max_pending,
            "max_wait_ticks": self.max_wait_ticks,
            "compile_count": self.compile_count,
            "images_entered": self._images,
            "tickets_open": len(self._tickets),
            "queued_images": self._queued,
            "pending_lanes": self._queued,
            "in_flight_rounds": self.in_flight_rounds,
            "rounds_served": self._rounds_served,
            "flush_count": self._flushes,
            "waited_ticks": self._waited_total,
        }
        if self._ring is not None:
            d["ring"] = self._ring.report()
        return d

    # -- internals ----------------------------------------------------------

    def _check_pending(self) -> None:
        if self._banked_rounds >= self.max_pending:
            raise RuntimeError(
                f"session holds {self._banked_rounds} completed rounds "
                f"(max_pending={self.max_pending}); drain with results()")

    def _age_partial(self) -> None:
        """Sub-round latency budget (``max_wait_ticks``): age the queued
        partial round by one session tick (a ``submit`` or ``ready``
        call); once it has waited the budget out, auto-flush it through
        as a masked partial round."""
        if not self._queued:
            self._waited = 0
            return
        if self.max_wait_ticks is None:
            return
        self._waited += 1
        self._waited_total += 1
        if self._waited >= self.max_wait_ticks:
            self.flush()

    def _take_round(self):
        """Pop up to round_batch queued images -> (segments, images)."""
        segs, parts, n = [], [], 0
        while self._queue and n < self.round_batch:
            entry = self._queue[0]
            uid, xs, off = entry
            take = min(xs.shape[0] - off, self.round_batch - n)
            parts.append(xs[off:off + take])
            segs.append((uid, take))
            n += take
            if off + take == xs.shape[0]:
                self._queue.popleft()
            else:
                entry[2] = off + take
        self._queued -= n
        return segs, parts[0] if len(parts) == 1 else torch.cat(parts)

    def _tick(self, segs, xs: torch.Tensor | None) -> None:
        """Advance one round: account its valid lanes, run it, deliver
        the round leaving the ring (on a single device: this one) to its
        tickets. ``segs`` None is a pipeline's empty drain tick."""
        n_valid = 0 if segs is None else sum(take for _uid, take in segs)
        if n_valid:
            self.counter.add_scaled(self._per_image, n_valid)
            self._images += n_valid
            self._rounds_served += 1
        if self._ring is None:
            # the copy in, the padding, the replay and the clone; the tick
            # timer takes the span's own duration
            with trace.timed("occam.session.round", self.timers) as sp:
                if sp:
                    sp.set(round=self._rounds_served, lanes=n_valid,
                           tickets=tuple(uid for uid, _take in segs),
                           boundary_bytes=self._per_image.total_bytes)
                    per = self._step.per_replay
                    if per.launches:
                        sp.set(weight_bytes=per.weight_bytes)
                lanes = self._step(self.params, xs)
            self._deliver(segs, lanes)
            return
        ring = self._ring
        mask = np.zeros(ring.round_width, dtype=bool)
        if n_valid:
            in_round = ring.pack_round(xs)
            mask[:-(-n_valid // self.microbatch)] = True
        else:
            in_round = self._empty_round
        self._masks = [mask] + self._masks[:-1]
        self._state, lanes = ring.tick(self.params, self._state, in_round,
                                       np.stack(self._masks))
        if self.ring_depth > 1:
            self._in_flight.appendleft(segs if n_valid else None)
            exiting = self._in_flight.pop()
        else:
            exiting = segs if n_valid else None
        if exiting is not None:
            self._deliver(exiting, lanes)

    def _deliver(self, segs, lanes: torch.Tensor) -> None:
        off = 0
        for uid, take in segs:
            ts = self._tickets[uid]
            ts.chunks.append(lanes[off:off + take])
            ts.remaining -= take
            off += take
        self._banked_rounds += 1

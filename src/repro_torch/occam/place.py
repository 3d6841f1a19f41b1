"""Stage 2 of the deployment API: ``Plan.place(...)`` -> :class:`Placement`.

A Placement binds a :class:`~repro_torch.occam.Plan` to devices: either
the degenerate single-device case (all spans in sequence on one device —
the paper's single-inference slice) or a STAP pipeline placement wrapping
a :class:`~repro_torch.core.stap.StapPlan` (one stage per span,
bottleneck stages replicated, mini-batch m staggered onto replica m mod
r_i) whose executable form is
:func:`~repro_torch.core.stap.staggered_schedule`. A pipeline's mesh
positions are devices; one device may hold several of them, so one GPU
(``compile(device="cuda:0")``) or the CPU (``device="cpu"``) runs any
pipeline placement.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import torch

from repro_torch.core.stap import (StapPlan, StaggeredSchedule,
                                   SteadySchedule, staggered_schedule,
                                   steady_schedule)

from .plan import Plan

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .deploy import Deployment

SINGLE = "single"
PIPELINE = "pipeline"


@dataclasses.dataclass
class Placement:
    plan: Plan
    kind: str                              # SINGLE | PIPELINE
    microbatch: int                        # images per pipeline slot
    stap: StapPlan | None = None           # PIPELINE only
    stage_times: tuple[float, ...] | None = None
    # the devices the caller placed the mesh on (a mesh's positions in
    # row-major order), or None: chosen at compile time
    devices: tuple | None = None
    # device layout of the serving ring: "rect" = (stage, replica) mesh
    # padded to max(replicas); "sum" = flat sum(replicas)-position
    # packing (paper §III-E accounting — see occam.calibrate.placement)
    packing: str = "rect"

    @property
    def chips(self) -> int:
        """Chips the plan accounts for: sum of replicas (§III-E)."""
        return 1 if self.kind == SINGLE else self.stap.chips

    @property
    def devices_needed(self) -> int:
        """Mesh positions the serving ring occupies under this packing:
        ``sum(replicas)`` packed, ``stages x max(replicas)``
        rectangular."""
        if self.kind == SINGLE:
            return 1
        if self.packing == "sum":
            return self.stap.chips
        return len(self.stap.replicas) * max(self.stap.replicas)

    @property
    def replicas(self) -> tuple[int, ...]:
        if self.kind == SINGLE:
            return (1,)
        return self.stap.replicas

    def schedule(self, n_microbatches: int) -> StaggeredSchedule:
        """The explicit lock-step tick schedule for a stream (PIPELINE)."""
        if self.kind != PIPELINE:
            raise ValueError("single-device placements have no staggered "
                             "schedule")
        return staggered_schedule(self.stap, n_microbatches)

    def steady_schedule(self) -> SteadySchedule:
        """The ring-of-rounds steady-state view (PIPELINE): the static
        per-tick facts a serving session builds against, independent of
        any stream length."""
        if self.kind != PIPELINE:
            raise ValueError("single-device placements have no steady "
                             "schedule; serve() runs whole rounds per tick")
        return steady_schedule(self.stap)

    @property
    def ring_depth(self) -> int:
        """Rounds resident in the serving ring — submit-to-result latency
        in ticks (1 for the single-device degenerate case)."""
        return 1 if self.kind == SINGLE else len(self.stap.replicas)

    def serve_geometry(self, round_batch: int | None = None
                       ) -> tuple[int, int]:
        """Size one serving round: ``(round_batch, microbatch)``.

        A pipeline session's tick is ``round_width`` slots wide (lcm of
        the replica counts — the slot -> replica assignment must repeat
        every round), so ``round_batch`` must be a positive multiple of
        it; the per-slot microbatch is what scales. Default: the plan's
        recorded serving default, else round_width x the placement
        microbatch. Single-device rounds have width 1 — any positive
        ``round_batch`` works.
        """
        if round_batch is None:
            round_batch = self.plan.serving.round_batch
        width = 1 if self.kind == SINGLE else \
            self.steady_schedule().round_width
        if round_batch is None:
            round_batch = width * self.microbatch
        round_batch = int(round_batch)
        if round_batch < 1 or round_batch % width:
            raise ValueError(
                f"round_batch must be a positive multiple of the round "
                f"width {width} (lcm of replicas "
                f"{tuple(self.replicas)}), got {round_batch}")
        return round_batch, round_batch // width

    def compile(self, backend: str = "auto", *,
                device: str | torch.device | None = None,
                devices: Sequence | None = None) -> "Deployment":
        """Stage 3: lower onto engines -> :class:`~repro_torch.occam
        .Deployment`.

        ``backend``: ``"auto"`` or any registered engine name (forced for
        every span; a pipeline placement takes only engines with a stage
        body, ``spmd_capable``). ``device``: where a single-device
        placement runs; ``None`` means the GPU (``"cuda"``), and raises
        when no GPU is visible — pass ``device="cpu"`` to run on the CPU.
        A pipeline placement's mesh goes on ``devices=`` (a list, one
        device per position, repeats allowed; default: the placement's),
        or every position on the one ``device`` (``"cuda:0"``,
        ``"cpu"``), or else on the visible GPUs, one position each —
        fewer than ``devices_needed`` raises.
        """
        from .deploy import Deployment

        if self.kind == SINGLE:
            if devices is not None:
                raise ValueError("devices= places a pipeline's mesh; a "
                                 "single-device placement takes device=")
            if device is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "Placement.compile() runs on the GPU by default, "
                        "and no CUDA device is visible; pass "
                        "device=\"cpu\" to run on the CPU")
                device = "cuda"
            return Deployment(self, backend=backend,
                              device=torch.device(device))
        if device is not None and devices is not None:
            raise ValueError("pass device= (every position on one device) "
                             "or devices= (one per position), not both")
        need = self.devices_needed
        if devices is None:
            devices = self.devices
        if device is not None:
            # enough positions for the rectangular batch program too: run()
            # executes it whatever the ring's packing
            reps = self.stap.replicas
            devices = [torch.device(device)] * (len(reps) * max(reps))
        elif devices is None:
            found = torch.cuda.device_count()
            if found < need:
                raise RuntimeError(
                    f"this pipeline placement's mesh has {need} positions "
                    f"and {found} CUDA devices are visible; pass "
                    f"device=\"cuda:0\" to host every position on one GPU "
                    f"(or device=\"cpu\"), or devices= a list of {need}")
            devices = [torch.device("cuda", i) for i in range(need)]
        return Deployment(self, backend=backend,
                          devices=tuple(torch.device(d) for d in devices))


def place_plan(plan: Plan, *, chips: int | None = None,
               replicas: Sequence[int] | None = None,
               stage_times: Sequence[float] | None = None,
               target_period: float | None = None,
               max_replicas: int | None = None,
               microbatch: int | None = None,
               mesh=None, devices=None,
               pipeline: bool | None = None,
               harmonize: bool = False,
               packing: str = "rect") -> Placement:
    """Implementation of :meth:`Plan.place` (see its docstring)."""
    if packing not in ("rect", "sum"):
        raise ValueError(f"packing must be 'rect' or 'sum', got {packing!r}")
    microbatch = microbatch if microbatch is not None else plan.batch
    # Any multi-chip knob selects the pipeline: a knob that would
    # otherwise be silently dropped (measured stage_times, a replica cap,
    # a device list) must never produce a single-chip placement.
    multichip_args = (chips, replicas, target_period, mesh, stage_times,
                      max_replicas, devices)
    want_pipeline = pipeline or any(a is not None for a in multichip_args)
    if pipeline is False and any(a is not None for a in multichip_args):
        raise ValueError("pipeline=False conflicts with multi-chip "
                         "arguments (chips/replicas/target_period/mesh/"
                         "stage_times/max_replicas/devices)")
    if not want_pipeline:
        if packing == "sum":
            raise ValueError("packing='sum' applies to pipeline "
                             "placements only")
        return Placement(plan, SINGLE, microbatch)

    # Stage latencies: measured if the caller has them, else the MAC model.
    from repro_torch.runtime.stap_pipeline import (default_stap_plan,
                                                   model_stage_times,
                                                   plan_span_stages)

    stages = plan_span_stages(plan.net, plan.partition, routes=plan.routes)
    times = tuple(stage_times) if stage_times is not None \
        else model_stage_times(plan.net, stages)
    if len(times) != len(stages):
        raise ValueError(f"{len(times)} stage times for "
                         f"{len(stages)} spans")
    if replicas is not None:
        # explicit replicas are a full specification; a budget or cap
        # alongside them would be silently unenforced, so reject it
        if chips is not None or target_period is not None \
                or max_replicas is not None:
            raise ValueError("replicas= is an explicit replica vector; it "
                             "conflicts with chips/target_period/"
                             "max_replicas (pick one way to plan)")
        reps = tuple(int(r) for r in replicas)
        if len(reps) != len(stages):
            raise ValueError(f"{len(reps)} replica counts for "
                             f"{len(stages)} spans")
        thr = 1.0 / max(t / r for t, r in zip(times, reps))
        stap = StapPlan(times, reps, thr, sum(times), sum(reps))
    else:
        stap = default_stap_plan(times, max_chips=chips,
                                 max_replicas=max_replicas,
                                 target_period=target_period,
                                 mesh=mesh, devices=devices,
                                 harmonize=harmonize)
    # a mesh the caller built fixes the positions: its devices in
    # row-major order rebuild it at compile time
    if devices is None and mesh is not None:
        devices = mesh.flat
    return Placement(plan, PIPELINE, microbatch, stap=stap,
                     stage_times=times,
                     devices=(tuple(torch.device(d) for d in devices)
                              if devices is not None else None),
                     packing=packing)

"""Stages 3-4 of the deployment API: ``Placement.compile`` ->
:class:`Deployment` -> ``run`` / ``report``.

Compiling binds the placement to engines through the registry: under
``backend="auto"`` each span keeps the route the planner picked; a forced
backend re-routes every span onto one engine (or raises
:class:`~repro_torch.occam.registry.BackendError` if a span is ineligible
— never a silent substitution). Single-device deployments execute through
``repro_torch.runtime.span_engine.execute_partition`` on the deployment's
device.

Every ``run`` accumulates off-chip transfers into one
:class:`~repro_torch.core.traffic.TrafficCounter`; ``report()`` returns
the plan's predicted per-image :class:`~repro_torch.core.traffic
.TrafficReport` with the measurement attached — model vs machine in one
object.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import convert
from repro_torch.core.traffic import TrafficCounter, TrafficReport
from repro_torch.runtime import span_engine

from . import registry
from .place import Placement


class Deployment:
    """A compiled, runnable placement. Build via ``Placement.compile``."""

    def __init__(self, placement: Placement, backend: str = registry.AUTO,
                 *, device: torch.device):
        if backend != registry.AUTO:
            registry.get_engine(backend)  # unknown names fail here
        self.placement = placement
        self.plan = placement.plan
        self.backend = backend
        self.device = device
        # forced backends re-route at compile time; BackendError surfaces
        # any span the engine cannot take
        self.routes = self.plan.routes if backend == registry.AUTO else \
            span_engine.plan_routes(self.plan.net, self.plan.partition,
                                    backend=backend,
                                    out_rows=self.plan.out_rows)
        self.counter = TrafficCounter()
        self._images = 0

    @property
    def kind(self) -> str:
        return self.placement.kind

    def run(self, params: Sequence[dict], xs,
            counter: TrafficCounter | None = None) -> torch.Tensor:
        """Execute one batch ((B, H, W, C) or one (H, W, C) image) on the
        deployment's device. ``params`` and ``xs`` may be numpy arrays or
        tensors anywhere; they move to the device first. ``counter``, if
        given, also receives this call's transfers (the deployment always
        accumulates its own)."""
        xs = convert.array_from_numpy(xs, self.device)
        params = convert.params_from_numpy(params, self.device)
        r0, w0 = self.counter.reads, self.counter.writes
        rb0, wb0 = self.counter.read_bytes, self.counter.write_bytes
        y = span_engine.execute_partition(
            params, xs, self.plan.net, self.plan.partition,
            counter=self.counter, routes=self.routes,
            out_rows=self.plan.out_rows)
        self._images += xs.shape[0] if xs.ndim == 4 else 1
        if counter is not None:
            counter.reads += self.counter.reads - r0
            counter.writes += self.counter.writes - w0
            counter.read_bytes += self.counter.read_bytes - rb0
            counter.write_bytes += self.counter.write_bytes - wb0
        return y

    def report(self) -> TrafficReport:
        """Predicted and measured traffic in one object (per-image
        prediction + everything counted since compile)."""
        return self.plan.predicted.with_measured(self.counter, self._images)

    def describe(self) -> dict:
        """Machine-readable deployment configuration (benchmarks, logs)."""
        return {
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
            "quant": None,
        }

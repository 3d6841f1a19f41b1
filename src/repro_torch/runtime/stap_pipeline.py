"""STAP pipeline planning: boundary payloads and per-span stages.

The static planning half of the reference's ``runtime/stap_pipeline.py``:
what crosses each partition cut (:class:`PayloadSpec`), each span as a
pipeline stage with its route and payloads (:class:`StageSpec`,
:func:`plan_span_stages`), and the MAC-count stage latency model
(:func:`model_stage_times`). These are pure functions of the net and the
partition; ``occam.autoplan`` scores candidates with them, and
``Deployment.profile`` measures the stages they describe.

The executable half (``StapPipeline``, ``StapRing``, ``make_stage_body``,
``default_stap_plan``) comes with the STAP multi-chip pipeline slice of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.graph import NetSpec
from repro_torch.core.partition import PartitionResult
from repro_torch.runtime import span_engine


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """What crosses a partition cut: the boundary map plus every residual
    source with an edge straddling the cut. ``elems`` is therefore exactly
    the per-boundary quantity the DP charges (one direction)."""

    cut: int
    keys: tuple[int, ...]   # [cut, *sorted crossing residual sources]
    elems: int              # per-image payload elements


def payload_spec(net: NetSpec, cut: int) -> PayloadSpec:
    extras = sorted({s for (s, t) in net.residual_edges if s < cut < t})
    keys = (cut, *extras)
    return PayloadSpec(cut, keys, sum(net.map_elems(k) for k in keys))


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a span, its engine route, and its payloads."""

    route: span_engine.SpanRoute
    in_spec: PayloadSpec
    out_spec: PayloadSpec
    spill: tuple[int, ...]     # interior maps this span must materialize
    src_keys: tuple[int, ...]  # upstream sources consumed from the payload

    @property
    def span(self) -> tuple[int, int]:
        return self.route.start, self.route.end


def plan_span_stages(net: NetSpec,
                     partition: PartitionResult | Sequence[int],
                     routes: Sequence[span_engine.SpanRoute] | None = None
                     ) -> tuple[StageSpec, ...]:
    """Pure function of net + partition: spans -> pipeline stages.

    ``routes`` overrides the registry's auto dispatch (forced backends
    from ``Placement.compile``); it must cover exactly the partition's
    spans."""
    boundaries = span_engine._boundaries_of(partition, net)
    if routes is None:
        routes = span_engine.plan_routes(net, partition)
    crossing = [(s, t) for (s, t) in net.residual_edges
                if any(s < p < t for p in boundaries)]
    spill_sources = {s for (s, _t) in crossing}
    stages = []
    for route in routes:
        a, b = route.start, route.end
        stages.append(StageSpec(
            route=route,
            in_spec=payload_spec(net, a),
            out_spec=payload_spec(net, b),
            spill=tuple(sorted(m for m in spill_sources if a < m < b)),
            src_keys=tuple(sorted({s for (s, t) in net.residual_edges
                                   if s < a < t <= b})),
        ))
    return tuple(stages)


def model_stage_times(net: NetSpec, stages: Sequence[StageSpec]
                      ) -> tuple[float, ...]:
    """Per-stage latency model for planning when no measured times exist:
    conv MACs plus pool window ops (arbitrary units — only ratios matter
    to ``plan_replication``)."""
    times = []
    for st in stages:
        a, b = st.span
        ops = 0
        for layer in net.layers[a:b]:
            ops += layer.macs if layer.kind == "conv" \
                else layer.out_elems * layer.k * layer.k
        times.append(float(max(ops, 1)))
    return tuple(times)

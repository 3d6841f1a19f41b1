"""Stage 1 of the deployment API: ``occam.plan`` -> :class:`Plan`.

A Plan is the frozen result of Occam's DP for one (net, capacity, batch)
triple: the optimal partition, the engine route the registry picked for
each span, and the predicted per-image :class:`~repro_torch.core.traffic
.TrafficReport`. It is the artifact that ships — ``to_json`` / ``save``
produce a self-contained document (the net spec rides along) a serving
host can ``load_plan`` and compile without re-running the planner.

The document format is the reference package's, schema v5, so a plan
written by either package loads in the other. A plan may carry a measured
cost model (the schema-v4 ``calibration`` block, an
``occam.calibrate.CostModel``) and a dtype policy (the schema-v5 ``quant``
block).
"""
from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.graph import NetSpec, net_from_dict, net_to_dict
from repro_torch.core.partition import PartitionResult, Span, partition_cnn
from repro_torch.core.traffic import TrafficReport, occam_traffic
from repro_torch.runtime import span_engine

from .fleet import Fleet

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .place import Placement
    from .quant import DtypePolicy

# v1: partition + routes + prediction. v2 adds the "serving" block
# (session defaults: round_batch, ring_depth). v3 adds the "fleet" block
# and the optional "out_rows" key (absent means 1). v4 adds the optional
# "calibration" block, v5 the optional "quant" block (absent or null
# means the implicit fp32 policy; a non-null quant key on a document
# stamped v4 or earlier is rejected). ``load_plan`` migrates earlier
# payloads transparently.
PLAN_FORMAT_VERSION = 5
_READABLE_VERSIONS = (1, 2, 3, 4, 5)

_V1_KEYS = frozenset({"version", "net", "capacity_elems", "batch",
                      "boundaries", "spans", "transfers", "routes",
                      "predicted"})
PLAN_KEYS_BY_VERSION: dict[int, frozenset[str]] = {
    1: _V1_KEYS,
    2: _V1_KEYS | {"serving"},
    3: _V1_KEYS | {"serving", "fleet", "out_rows"},
    4: _V1_KEYS | {"serving", "fleet", "out_rows", "calibration"},
    5: _V1_KEYS | {"serving", "fleet", "out_rows", "calibration",
                   "quant"},
}

_PREDICTED_FIELDS = ("scheme", "feature_elems", "filter_elems",
                     "compute_macs", "boundary_elems")

@dataclasses.dataclass(frozen=True)
class ServingDefaults:
    """Serving-session defaults that ship with a plan (schema v2).

    ``round_batch``: images per serving round (``None``: derived at serve
    time). ``ring_depth``: rounds resident in the serving ring — one per
    pipeline stage.
    """

    round_batch: int | None = None
    ring_depth: int | None = None

    def to_dict(self) -> dict:
        return {"round_batch": self.round_batch,
                "ring_depth": self.ring_depth}

    @classmethod
    def from_dict(cls, d: dict | None) -> "ServingDefaults":
        d = d or {}
        rb, rd = d.get("round_batch"), d.get("ring_depth")
        return cls(int(rb) if rb is not None else None,
                   int(rd) if rd is not None else None)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What to run where, before any hardware is committed.

    ``batch`` is the number of images concurrently resident per chip (the
    DP scales feature-map closures by it — Eqn. 6 keeps filters shared).
    """

    net: NetSpec
    capacity_elems: int
    batch: int
    partition: PartitionResult
    routes: tuple[span_engine.SpanRoute, ...]
    predicted: TrafficReport   # per-image, scheme="occam"
    serving: ServingDefaults = ServingDefaults()  # session defaults (v2)
    fleet: Fleet | None = None  # hardware model planned against (v3)
    # output tile height t (rows per kernel step, Eqn. 6 amortization);
    # spans whose output map is shorter clamp per-span at execution
    out_rows: int = 1
    # measured cost rates the plan was last calibrated with (v4):
    # an ``occam.calibrate.CostModel``, or None = uncalibrated
    calibration: object | None = None
    # dtype policy planned under (v5); None is the implicit fp32 policy
    quant: "DtypePolicy | None" = None

    # -- introspection ------------------------------------------------------

    @property
    def boundaries(self) -> list[int]:
        return list(self.partition.boundaries)

    @property
    def n_spans(self) -> int:
        return self.partition.n_spans

    @property
    def predicted_transfers(self) -> int:
        """Per-image off-chip elements of the chosen PBS (the DP's X)."""
        from repro_torch.models.cnn import predicted_transfers

        return predicted_transfers(self.net, self.boundaries)

    def with_calibration(self, cost_model) -> "Plan":
        """This plan carrying a measured ``occam.calibrate.CostModel``
        (persisted in the schema-v4 ``calibration`` block)."""
        return dataclasses.replace(self, calibration=cost_model)

    # -- stage 2 ------------------------------------------------------------

    def place(self, *, chips: int | None = None,
              replicas: Sequence[int] | None = None,
              stage_times: Sequence[float] | None = None,
              target_period: float | None = None,
              max_replicas: int | None = None,
              microbatch: int | None = None,
              mesh=None, devices=None,
              pipeline: bool | None = None,
              harmonize: bool = False,
              packing: str = "rect",
              audit: str = "warn") -> "Placement":
        """Commit the plan to devices -> :class:`~repro_torch.occam
        .Placement`.

        With no arguments: the single-device placement (every span
        executes in sequence on one device). Any multi-chip argument
        (``chips`` / ``replicas`` / ``stage_times`` / ``target_period`` /
        ``max_replicas`` / ``mesh`` / ``devices`` / ``pipeline=True``)
        gives a STAP pipeline placement: one stage per span, replicas
        from ``replicas=`` or planned by ``plan_replication`` under the
        budget (``harmonize`` snaps them to divisors of the largest),
        capped at what ``mesh`` / ``devices`` / the visible GPUs can hold.
        ``packing`` (``"rect"`` or ``"sum"``) is a pipeline placement's
        device layout; ``"sum"`` on a single placement raises
        ``ValueError``.
        ``audit`` statically verifies the resulting placement
        (``occam.audit``): ``"warn"`` (default) emits an
        ``AuditWarning`` on error findings, ``"error"`` raises
        ``AuditError``, ``"off"`` skips the check.
        """
        from .place import place_plan

        return place_plan(self, chips=chips, replicas=replicas,
                          stage_times=stage_times,
                          target_period=target_period,
                          max_replicas=max_replicas, microbatch=microbatch,
                          mesh=mesh, devices=devices, pipeline=pipeline,
                          harmonize=harmonize, packing=packing,
                          audit=audit)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": PLAN_FORMAT_VERSION,
            "net": net_to_dict(self.net),
            "capacity_elems": self.capacity_elems,
            "batch": self.batch,
            "boundaries": self.boundaries,
            "spans": [[sp.start, sp.end, sp.fits]
                      for sp in self.partition.spans],
            "transfers": self.partition.transfers,
            "routes": [[r.start, r.end, r.route, r.reason]
                       for r in self.routes],
            "predicted": {f: getattr(self.predicted, f)
                          for f in _PREDICTED_FIELDS},
            "serving": self.serving.to_dict(),
            "fleet": self.fleet.to_dict() if self.fleet else None,
            "out_rows": self.out_rows,
            "calibration": (self.calibration.to_dict()
                            if self.calibration is not None else None),
            "quant": (self.quant.to_dict()
                      if self.quant is not None else None),
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def plan(net: NetSpec, capacity_elems: int, *, batch: int = 1,
         round_batch: int | None = None,
         fleet: Fleet | None = None, out_rows: int = 1,
         dtype_policy=None) -> Plan:
    """Run the DP + engine routing for ``net`` under ``capacity_elems``.

    ``round_batch`` records a serving-round size with the plan (schema
    v2). ``fleet`` records the hardware model the capacity came from
    (schema v3). ``out_rows`` is the output tile height t (output
    row-planes per kernel step — the paper's Table II TileDim); each span
    clamps it to its own output height at execution. ``dtype_policy``
    makes dtype a planning axis (schema v5): a ``occam.quant.DtypePolicy``
    (or preset name like ``"int8"``) under which the DP charges boundary
    *bytes* and footprints shrink by the narrower widths — a quantized
    boundary can move the cut. ``None`` is the implicit fp32 policy.
    """
    if out_rows < 1:
        raise ValueError(f"out_rows must be >= 1, got {out_rows}")
    from .quant import resolve_policy

    policy = resolve_policy(dtype_policy)
    part = partition_cnn(net, capacity_elems, batch=batch, policy=policy)
    routes = span_engine.plan_routes(
        net, part, out_rows=out_rows,
        dtype=policy.compute if policy is not None else None)
    predicted = occam_traffic(net, capacity_elems, batch, part,
                              policy=policy)
    serving = ServingDefaults(round_batch, part.n_spans)
    return Plan(net, capacity_elems, batch, part, routes, predicted,
                serving, fleet, out_rows, quant=policy)


def plan_from_dict(d: dict) -> Plan:
    version = d.get("version")
    if version not in _READABLE_VERSIONS:
        raise ValueError(f"unsupported plan version {version!r} "
                         f"(this build reads {_READABLE_VERSIONS})")
    # strict mode on current-version documents: a key this writer could
    # not have produced is a corrupted or hand-edited artifact
    if version == PLAN_FORMAT_VERSION:
        unknown = sorted(set(d) - PLAN_KEYS_BY_VERSION[version])
        if unknown:
            raise ValueError(
                f"plan document carries unknown top-level key(s) "
                f"{unknown}; schema version {version} defines "
                f"{sorted(PLAN_KEYS_BY_VERSION[version])}")
    net = net_from_dict(d["net"])
    spans = [Span(int(s), int(e), bool(f)) for (s, e, f) in d["spans"]]
    # The DP tables are planner scratch, not part of the shipped artifact
    part = PartitionResult([int(b) for b in d["boundaries"]], spans,
                           float(d["transfers"]), {}, {})
    routes = tuple(span_engine.SpanRoute(int(a), int(b), route, reason)
                   for (a, b, route, reason) in d["routes"])
    predicted = TrafficReport(**d["predicted"])
    if version == 1:
        # v1 had no serving block: derive the ring depth from the partition
        serving = ServingDefaults(None, len(spans))
    else:
        serving = ServingDefaults.from_dict(d.get("serving"))
    # v1/v2 had no fleet block: the plan's capacity stands alone
    fleet = Fleet.from_dict(d["fleet"]) \
        if version >= 3 and d.get("fleet") else None
    # v1-v3 had no calibration block: the plan loads uncalibrated
    calibration = None
    if version >= 4 and d.get("calibration"):
        from .calibrate.cost_model import CostModel

        calibration = CostModel.from_dict(d["calibration"])
    # v1-v4 documents are implicitly fp32; a non-null quant key on one is
    # a mislabeled artifact, not a migration case: reject it
    quant = None
    if version >= 5 and d.get("quant"):
        from .quant import DtypePolicy

        quant = DtypePolicy.from_dict(d["quant"])
    elif version < 5 and d.get("quant") is not None:
        raise ValueError(
            f"plan document stamped version {version} carries a 'quant' "
            f"block; dtype policies require schema version 5")
    if quant is not None:
        # predicted serializes elem counts only; the byte widths are a
        # pure function of the policy, so re-stamp them
        predicted = dataclasses.replace(
            predicted,
            boundary_bytes_per_elem=quant.boundary_bytes,
            filter_bytes_per_elem=quant.weight_bytes)
    return Plan(net, int(d["capacity_elems"]), int(d["batch"]), part,
                routes, predicted, serving, fleet,
                int(d.get("out_rows", 1)), calibration, quant)


def plan_from_json(doc: str) -> Plan:
    return plan_from_dict(json.loads(doc))


def load_plan(path: str) -> Plan:
    with open(path) as f:
        return plan_from_json(f.read())

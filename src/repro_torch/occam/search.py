"""Objective-driven planning frontier: ``occam.autoplan(net, fleet)``.

The staged API's front door used to be hand-fed: the caller asserted a
``capacity_elems`` for :func:`~repro_torch.occam.plan` and then
chips/replicas for ``Plan.place``. ``autoplan`` derives both from a
declarative :class:`~repro_torch.occam.Fleet`:

* **Capacity sweep** — the DP result only changes at the finite set of
  dependence-closure footprint thresholds <= ``fleet.vmem_elems``
  (``core.partition.PartitionSweep``), so the sweep shares one footprint
  table across all capacities and re-runs the DP only when the fits set
  changes (memoized, bisection-pruned — never from scratch per
  capacity).
* **Placement enumeration** — for each distinct optimal partition, every
  replica vector ``plan_replication`` produces under the fleet's chip
  budgets (water-fill per budget, replica axis capped at what an
  ``n_stages x max_replicas`` mesh can physically hold, round-width
  ``harmonize`` applied), plus the degenerate single-chip placement.
* **Scoring** — each (partition, placement) pair becomes a
  :class:`Candidate` scored on predicted off-chip traffic, steady period
  (inverse images/s, roofline-bounded by the fleet's optional HBM and
  link bandwidths), fill latency, and chips occupied, reusing
  ``plan_replication`` / ``steady_schedule`` arithmetic.

The Pareto-optimal candidates form a :class:`Frontier`:
``Frontier.best(objective)`` picks per objective,
``Candidate.deploy(backend=)`` compiles through the ordinary staged path
(``place -> compile``), and ``to_json`` / :func:`load_frontier` ship the
whole frontier to a serving host exactly like plans ship (each candidate
embeds its schema-v3 plan). At serve time ``Session.scale(arrival_rate=)``
/ ``Deployment.reconcile(...)`` re-pick from the frontier — autoscaling
without ever re-running the DP.

This is the reference package's module with two differences: a
candidate deploys onto an explicit ``device`` (``Candidate.deploy``; a
pipeline candidate's every mesh position on that device, or one visible
GPU per position by default), and ``Frontier.serve`` raises until the
async-engine slice of the port lands.
Everything else, the scoring arithmetic included, is the reference's
text, so a frontier document written by either package loads in the
other and re-serializes to the same dict.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import TYPE_CHECKING, Sequence

import torch

from repro_torch.core.graph import NetSpec
from repro_torch.core.partition import PartitionResult, PartitionSweep
from repro_torch.core.stap import plan_replication
from repro_torch.core.traffic import occam_traffic

from .fleet import Fleet
from .place import PIPELINE, SINGLE
from .plan import Plan, ServingDefaults, plan_from_dict

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .deploy import Deployment
    from .place import Placement

FRONTIER_FORMAT_VERSION = 1

# Authoritative top-level key set of a frontier document. Strict
# loading (``frontier_from_dict`` rejects unknown keys on
# current-version documents) and the ``occam.audit`` OCM001 document
# rule share this table.
FRONTIER_DOCUMENT_KEYS = frozenset({"version", "objective",
                                    "arrival_rate", "fleet", "stats",
                                    "candidates"})

OBJECTIVES = ("throughput", "latency", "traffic")

# sort keys per objective: minimize the named metric, break ties toward
# fewer chips and less traffic (the cheaper deployment wins a draw),
# then toward a deterministic structural tail so exact score ties never
# depend on enumeration order (stable picks across runs and re-scores)
def _det(c: "Candidate") -> tuple:
    # quant_cost leads: on an exact score tie the full-precision
    # candidate wins deterministically over its quantized twins
    return (c.quant_cost, c.traffic_bytes, c.kind, c.replicas,
            tuple(c.plan.boundaries))


_OBJECTIVE_KEYS = {
    "throughput": lambda c: (c.period, c.chips, c.traffic, c.fill_latency)
    + _det(c),
    "latency": lambda c: (c.fill_latency, c.chips, c.traffic, c.period)
    + _det(c),
    "traffic": lambda c: (c.traffic, c.period, c.chips, c.fill_latency)
    + _det(c),
}


@dataclasses.dataclass
class Candidate:
    """One point of the planning frontier: a (partition, placement) pair
    with its predicted scores.

    ``plan`` is a full schema-v3 :class:`~repro_torch.occam.Plan` (fleet block
    included); ``replicas`` / ``stage_times`` reproduce the placement via
    the ordinary ``Plan.place`` path. Scores: ``traffic`` (predicted
    off-chip elements per image), ``period`` (steady seconds per image —
    1/throughput), ``fill_latency`` (seconds until the first result),
    ``chips`` (devices the placement occupies: the ``stages x
    max(replicas)`` mesh for a pipeline, 1 for the degenerate case).
    """

    plan: Plan
    kind: str                      # SINGLE | PIPELINE
    replicas: tuple[int, ...]
    stage_times: tuple[float, ...]  # per-image stage latency model (MACs)
    traffic: float
    period: float
    fill_latency: float
    chips: int
    # byte-denominated twin of ``traffic`` (0.0 = derive as fp32) and the
    # plan's ordinal accuracy-headroom cost (0 = exact fp32): the two
    # extra Pareto axes a ``Fleet(dtype_policy=...)`` sweep trades —
    # cheaper bytes never silently evict the full-precision candidate
    traffic_bytes: float = 0.0
    quant_cost: int = 0
    _frontier: "Frontier | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    _deployments: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def throughput(self) -> float:
        """Predicted steady images per second (1 / period)."""
        return 1.0 / self.period

    @property
    def round_width(self) -> int:
        return functools.reduce(math.lcm, self.replicas, 1)

    def placement(self) -> "Placement":
        """Re-enter the staged path: the :class:`~repro_torch.occam
        .Placement` this candidate scored.

        Unbalanced replica vectors were scored at ``sum(replicas)``
        chips (§III-E), so they place with ``packing="sum"``; balanced
        vectors keep the rectangular mesh (same chip count either way).
        """
        if self.kind == SINGLE:
            return self.plan.place()
        packing = "sum" if sum(self.replicas) < \
            len(self.replicas) * max(self.replicas) else "rect"
        return self.plan.place(replicas=self.replicas,
                               stage_times=self.stage_times,
                               packing=packing)

    def deploy(self, backend: str = "auto", *,
               device: str | torch.device | None = None) -> "Deployment":
        """Compile this candidate -> :class:`~repro_torch.occam
        .Deployment` on ``device`` (``None``: the GPU, as
        ``Placement.compile``; a pipeline candidate puts every mesh
        position on ``device``, or with ``None`` one visible GPU per
        position).

        Deployments are cached per ``(backend, device)``, so
        frontier-driven autoscaling (``Session.scale`` /
        ``Deployment.reconcile``) flips between candidates without
        recompiling — and never re-runs the DP. ``"cuda"`` and
        ``torch.device("cuda")`` are one key.
        """
        key = (backend, torch.device("cuda" if device is None else device))
        dep = self._deployments.get(key)
        if dep is not None:
            # the cache survives re-scoring (rescored candidates share
            # it); point the deployment back at the candidate and
            # frontier actually asking for it
            dep.candidate = self
            dep.frontier = self._frontier
            return dep
        dep = self.placement().compile(backend=backend, device=device)
        dep.candidate = self
        dep.frontier = self._frontier
        self._deployments[key] = dep
        return dep

    def scores(self) -> dict:
        return {"traffic": self.traffic, "period": self.period,
                "fill_latency": self.fill_latency, "chips": self.chips,
                "traffic_bytes": self.traffic_bytes,
                "quant_cost": self.quant_cost}

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "replicas": list(self.replicas),
            "stage_times": list(self.stage_times),
            "scores": self.scores(),
            "plan": self.plan.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        s = d["scores"]
        return cls(plan=plan_from_dict(d["plan"]), kind=d["kind"],
                   replicas=tuple(int(r) for r in d["replicas"]),
                   stage_times=tuple(float(t) for t in d["stage_times"]),
                   traffic=float(s["traffic"]), period=float(s["period"]),
                   fill_latency=float(s["fill_latency"]),
                   chips=int(s["chips"]),
                   # pre-quant frontier documents carry neither key:
                   # fp32 bytes and zero accuracy cost
                   traffic_bytes=float(
                       s.get("traffic_bytes", s["traffic"] * 4.0)),
                   quant_cost=int(s.get("quant_cost", 0)))


def _dominates(a: Candidate, b: Candidate) -> bool:
    """Pareto order over (traffic, traffic_bytes, period, fill_latency,
    chips, quant_cost): a is at least as good everywhere and strictly
    better somewhere. ``quant_cost`` keeps the exact-fp32 candidate
    alive against its cheaper-in-bytes quantized twins."""
    le = (a.traffic <= b.traffic and a.traffic_bytes <= b.traffic_bytes
          and a.period <= b.period
          and a.fill_latency <= b.fill_latency and a.chips <= b.chips
          and a.quant_cost <= b.quant_cost)
    lt = (a.traffic < b.traffic or a.traffic_bytes < b.traffic_bytes
          or a.period < b.period
          or a.fill_latency < b.fill_latency or a.chips < b.chips
          or a.quant_cost < b.quant_cost)
    return le and lt


@dataclasses.dataclass
class Frontier:
    """The Pareto frontier ``autoplan`` returns: every candidate not
    dominated on (traffic, period, fill_latency, chips), sorted fastest
    first. Ships like a plan (``to_json`` / :func:`load_frontier`); a
    serving host re-picks from it at runtime (``for_rate`` /
    ``Deployment.reconcile``) without re-running any search."""

    fleet: Fleet
    objective: str
    candidates: tuple[Candidate, ...]
    arrival_rate: float | None = None
    stats: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for c in self.candidates:
            c._frontier = self

    def __len__(self) -> int:
        return len(self.candidates)

    def __iter__(self):
        return iter(self.candidates)

    def best(self, objective: str | None = None) -> Candidate:
        """The winning candidate for ``objective`` (default: the one
        ``autoplan`` was called with). When the frontier carries an
        ``arrival_rate``, only candidates meeting the rate compete
        (unless none does — then the honest best effort wins)."""
        objective = objective or self.objective
        if objective not in _OBJECTIVE_KEYS:
            raise ValueError(f"unknown objective {objective!r} "
                             f"(one of {OBJECTIVES})")
        pool = list(self.candidates)
        if self.arrival_rate is not None:
            meeting = [c for c in pool
                       if c.throughput >= self.arrival_rate]
            pool = meeting or pool
        return min(pool, key=_OBJECTIVE_KEYS[objective])

    def for_rate(self, arrival_rate: float) -> Candidate:
        """The cheapest candidate whose predicted throughput meets
        ``arrival_rate`` (fewest chips, then least traffic) — the
        serve-time autoscaling pick. Falls back to the highest-throughput
        candidate when no one meets the rate."""
        meeting = [c for c in self.candidates
                   if c.throughput >= arrival_rate]
        if meeting:
            return min(meeting,
                       key=lambda c: (c.chips, c.traffic, c.period)
                       + _det(c))
        return min(self.candidates,
                   key=lambda c: (c.period, c.chips, c.traffic)
                   + _det(c))

    def deploy(self, objective: str | None = None, backend: str = "auto",
               **kw) -> "Deployment":
        """``best(objective).deploy(...)`` in one call."""
        return self.best(objective).deploy(backend, **kw)

    def rescore(self, cost_model) -> "Frontier":
        """A new frontier re-ranked under a measured
        ``occam.calibrate.CostModel``: every candidate's period and fill
        latency recomputed with calibrated rates, Pareto re-filtered —
        the DP never re-runs, and deployment caches carry over (a
        re-scored winner re-deploys without recompiling)."""
        from .calibrate.rescore import rescore_frontier

        return rescore_frontier(self, cost_model)

    def serve(self, params, *, objective: str | None = None,
              backend: str = "auto", device=None, autoscale: bool = True,
              **engine_kw):
        """Frontier -> async serving in one call: the async engine is the
        async-engine slice of the port, which has not landed; this raises
        ``NotImplementedError``. Deploy a candidate and open a session
        instead (``best(objective).deploy(...).serve(params)``)."""
        raise NotImplementedError(
            "Frontier.serve wraps the best candidate in an async engine, "
            "the async-engine slice of the port, which has not landed; use "
            "best(objective).deploy(...).serve(params)")

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": FRONTIER_FORMAT_VERSION,
            "objective": self.objective,
            "arrival_rate": self.arrival_rate,
            "fleet": self.fleet.to_dict(),
            "stats": dict(self.stats),
            "candidates": [c.to_dict() for c in self.candidates],
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def frontier_from_dict(d: dict) -> Frontier:
    version = d.get("version")
    if version != FRONTIER_FORMAT_VERSION:
        raise ValueError(f"unsupported frontier version {version!r} "
                         f"(this build reads {FRONTIER_FORMAT_VERSION})")
    # strict mode (mirrors plan_from_dict): this writer could not have
    # produced an extra top-level key, so one marks a corrupted or
    # hand-edited artifact
    unknown = sorted(set(d) - FRONTIER_DOCUMENT_KEYS)
    if unknown:
        raise ValueError(
            f"frontier document carries unknown top-level key(s) "
            f"{unknown}; schema version {version} defines "
            f"{sorted(FRONTIER_DOCUMENT_KEYS)}")
    return Frontier(
        fleet=Fleet.from_dict(d["fleet"]),
        objective=d["objective"],
        candidates=tuple(Candidate.from_dict(c) for c in d["candidates"]),
        arrival_rate=(None if d.get("arrival_rate") is None
                      else float(d["arrival_rate"])),
        stats=dict(d.get("stats") or {}),
    )


def frontier_from_json(doc: str) -> Frontier:
    return frontier_from_dict(json.loads(doc))


def load_frontier(path: str) -> Frontier:
    with open(path) as f:
        return frontier_from_json(f.read())


# --------------------------------------------------------------------------
# The search
# --------------------------------------------------------------------------

def _make_plan(net: NetSpec, capacity: int, batch: int,
               part: PartitionResult, fleet: Fleet,
               out_rows: int = 1, policy=None) -> Plan:
    """A schema-v3/v5 Plan from an already-computed partition (the sweep
    never calls ``occam.plan`` — that would re-run the DP)."""
    from repro_torch.runtime import span_engine

    routes = span_engine.plan_routes(
        net, part, out_rows=out_rows,
        dtype=policy.compute if policy is not None else None)
    predicted = occam_traffic(net, capacity, batch, part, policy=policy)
    return Plan(net, capacity, batch, part, routes, predicted,
                ServingDefaults(None, part.n_spans), fleet, out_rows,
                quant=policy)


_MAX_AUTO_TILE = 8


def _pick_out_rows(net: NetSpec, capacity: int, batch: int,
                   part: PartitionResult) -> int:
    """Score the tile-height knob for one partition: the largest
    power-of-two t (capped at 8) whose grown closure still fits the
    capacity on EVERY fitting span — ``span_footprint_elems(...,
    out_rows=t)`` is the accounting, ``max_tile_rows`` its inverse.
    Oversized lower-bound spans are oracle-routed whole-map executions;
    tile height does not apply to them."""
    from repro_torch.core import closure

    t = _MAX_AUTO_TILE
    for sp in part.spans:
        if not sp.fits or sp.end - sp.start < 1:
            continue
        rows = closure.max_tile_rows(net, sp.start, sp.end, capacity,
                                     batch=batch)
        t = min(t, max(rows, 1))
    p = 1
    while p * 2 <= t:
        p *= 2
    return p


def _replica_vectors(stage_times: Sequence[float], fleet: Fleet,
                     harmonize: bool) -> list[tuple[int, ...]]:
    """Every distinct replica vector the fleet can host for this stage
    profile: water-fill under each chip budget, replica axis capped at
    what an S x r mesh physically fits."""
    s = len(stage_times)
    # sum-of-replicas packing (§III-E) hosts any vector with
    # sum(r) <= chips, so the replica axis can grow past chips // s
    r_cap_max = fleet.max_replicas(s, packing="sum")
    vectors: set[tuple[int, ...]] = set()
    for r_cap in range(1, r_cap_max + 1):
        for budget in range(s, min(s * r_cap, fleet.chips) + 1):
            rep = plan_replication(stage_times, max_chips=budget,
                                   max_replicas=r_cap,
                                   harmonize=harmonize).replicas
            if sum(rep) <= fleet.chips:
                vectors.add(rep)
    return sorted(vectors)


def _score(net: NetSpec, plan: Plan, fleet: Fleet, kind: str,
           replicas: tuple[int, ...],
           stage_times: tuple[float, ...]) -> Candidate:
    """Predict (traffic, period, fill latency, chips) for one placement.

    Stage times are the MAC-count model; ``fleet.macs_per_s`` converts to
    seconds so the optional HBM / link bandwidth bounds compose on one
    roofline axis. The per-slot microbatch cancels out of throughput
    (m images per slot, m x the slot time) but not out of latency.
    """
    times_s = [t / fleet.macs_per_s for t in stage_times]
    traffic = plan.predicted.offchip_elems
    traffic_bytes = plan.predicted.offchip_bytes
    policy = plan.quant
    # bandwidth rates are fp32-equivalent elements/s; a narrower
    # boundary ships fewer bytes through the same rate
    bnd_scale = (policy.boundary_bytes / 4.0) if policy is not None else 1.0
    batch = plan.batch
    if kind == SINGLE:
        period = sum(times_s)                      # one chip, spans in turn
        fill = batch * sum(times_s)
        chips = 1
        # single chip: span-boundary traffic is DRAM write+read — the
        # whole per-image quantity streams through this chip's HBM
        if fleet.hbm_elems_per_s is not None:
            period = max(period,
                         (traffic_bytes / 4.0) / fleet.hbm_elems_per_s)
    else:
        bottleneck = max(t / r for t, r in zip(times_s, replicas))
        period = bottleneck                        # 1 / closed-form thr
        width = functools.reduce(math.lcm, replicas, 1)
        # ring depth = n_stages ticks to first result, each tick
        # W * batch * bottleneck long (SteadySchedule.steady_tick_time)
        fill = len(replicas) * width * batch * bottleneck
        # sum-of-replicas accounting (§III-E): stages run asynchronously,
        # so a 4-3-2 plan occupies 9 chips, not a 3x4 rectangle
        chips = sum(replicas)
        # pipeline: boundary payloads move stage-to-stage over links
        # (ppermute is the runtime's ONLY inter-stage traffic; no chip
        # replays the whole net through its own HBM), so the busiest
        # cut's payload bounds the period against the link rate
        if fleet.link_elems_per_s is not None:
            from repro_torch.runtime.stap_pipeline import payload_spec

            link = max((payload_spec(net, b).elems * bnd_scale
                        / fleet.link_elems_per_s
                        for b in plan.boundaries), default=0.0)
            period = max(period, link)
    return Candidate(plan, kind, replicas, stage_times,
                     traffic=traffic, period=period, fill_latency=fill,
                     chips=chips, traffic_bytes=traffic_bytes,
                     quant_cost=policy.quant_cost if policy else 0)


def autoplan(net: NetSpec, fleet: Fleet, *,
             objective: str = "throughput", batch: int = 1,
             arrival_rate: float | None = None,
             harmonize: bool = True,
             out_rows: int | str = 1) -> Frontier:
    """Search (capacity x placement) under a fleet -> :class:`Frontier`.

    ``objective``: what ``Frontier.best()`` optimizes by default —
    ``"throughput"`` (min steady period), ``"latency"`` (min fill
    latency), or ``"traffic"`` (min predicted off-chip elements).
    ``batch`` is the per-chip resident image count, as in ``occam.plan``.
    ``arrival_rate`` (images/s) records the load the frontier should
    serve: ``best`` then prefers candidates meeting it, and
    ``Session.scale`` re-picks against observed rates. ``harmonize``
    applies the round-width economy pass to every enumerated replica
    vector (see ``core.stap.plan_replication``).
    ``out_rows`` sets the output tile height every candidate plan ships
    with; ``"auto"`` scores the knob per partition — the largest
    power-of-two t whose grown closure (``span_footprint_elems(...,
    out_rows=t)``) still fits the partition's capacity on every span.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r} "
                         f"(one of {OBJECTIVES})")
    if batch < 1:
        raise ValueError("batch must be >= 1")
    if out_rows != "auto" and (not isinstance(out_rows, int)
                               or out_rows < 1):
        raise ValueError(f"out_rows must be a positive int or 'auto', "
                         f"got {out_rows!r}")
    from repro_torch.runtime.stap_pipeline import (model_stage_times,
                                             plan_span_stages)

    from .quant import resolve_policies

    candidates: list[Candidate] = []
    stats = {"capacities_swept": 0, "dp_runs": 0, "dp_runs_hops": 0,
             "partitions": 0, "policies_swept": 0}
    # the dtype axis: each policy runs its own byte-denominated capacity
    # sweep (a narrower closure fits more layers per span — the fits set
    # genuinely differs), and its candidates join one shared Pareto pool
    for policy in resolve_policies(fleet.dtype_policy):
        stats["policies_swept"] += 1
        sweep = PartitionSweep(net, batch, policy=policy)
        swept = sweep.sweep(fleet.vmem_elems)

        # distinct partitions only — keep the LARGEST capacity achieving
        # each boundary set (swept ascending, last wins): traffic is
        # identical by construction, but the per-span fits flags grow
        # with capacity and drive engine routing — the deployed chip
        # really holds fleet.vmem_elems, so a span it can hold must not
        # ship flagged as an oversized-lower-bound (oracle-routed) span
        by_boundaries: dict[tuple, tuple[int, PartitionResult]] = {}
        for pt in swept:
            by_boundaries[tuple(pt.result.boundaries)] = \
                (pt.capacity_elems, pt.result)

        # pipeline candidates pay boundary traffic as link hops, not
        # DRAM round-trips, so the hop-count DP (cost="hops") can prefer
        # cuts the DRAM objective rejects — sweep it too (footprint memo
        # is shared; only genuinely new fits-sets run the DP) and score
        # any partitions the DRAM sweep did not already find as
        # pipeline-only candidates
        hop_only: dict[tuple, tuple[int, PartitionResult]] = {}
        if fleet.chips > 1:
            for pt in sweep.sweep(fleet.vmem_elems, cost="hops"):
                key = tuple(pt.result.boundaries)
                if key not in by_boundaries:
                    hop_only[key] = (pt.capacity_elems, pt.result)

        for source in (by_boundaries, hop_only):
            for capacity, part in source.values():
                t = (_pick_out_rows(net, capacity, batch, part)
                     if out_rows == "auto" else int(out_rows))
                plan = _make_plan(net, capacity, batch, part, fleet, t,
                                  policy=policy)
                stages = plan_span_stages(net, part, routes=plan.routes)
                times = model_stage_times(net, stages)
                s = len(stages)
                if source is by_boundaries:
                    candidates.append(_score(net, plan, fleet, SINGLE,
                                             (1,) * s, times))
                if fleet.max_replicas(s, packing="sum") >= 1:
                    for reps in _replica_vectors(times, fleet, harmonize):
                        candidates.append(_score(net, plan, fleet,
                                                 PIPELINE, reps, times))
        stats["capacities_swept"] += len(swept)
        stats["dp_runs"] += sweep.dp_runs_by_cost.get("dram", 0)
        stats["dp_runs_hops"] += sweep.dp_runs_by_cost.get("hops", 0)
        stats["partitions"] += len(by_boundaries) + len(hop_only)

    # exact-score duplicates are interchangeable (e.g. extra replicas
    # inside the same mesh footprint that don't move the bottleneck) —
    # keep the one powering the fewest chips
    dedup: dict[tuple, Candidate] = {}
    for c in candidates:
        key = (c.traffic, c.period, c.fill_latency, c.chips,
               c.traffic_bytes, c.quant_cost)
        prev = dedup.get(key)
        if prev is None or sum(c.replicas) < sum(prev.replicas):
            dedup[key] = c
    unique = list(dedup.values())
    pareto = [c for c in unique
              if not any(_dominates(o, c) for o in unique)]
    pareto.sort(key=_OBJECTIVE_KEYS[objective])
    stats["placements_scored"] = len(candidates)
    stats["pareto_size"] = len(pareto)
    return Frontier(fleet, objective, tuple(pareto),
                    arrival_rate=arrival_rate, stats=stats)

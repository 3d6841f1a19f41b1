"""Occam's optimal-partition dynamic program (paper §III-D).

Partitions a layer chain into contiguous spans such that each span's
footprint (dependence closure + chip-resident filters) fits the on-chip
capacity ``C``, provably minimizing off-chip transfers at span boundaries.

The DP is written against an abstract :class:`PartitionProblem` so the same
optimal machinery drives (a) the paper's CNNs (closure footprints) and
(b) transformer pipeline-stage assignment (HBM footprints) — see
``partition_transformer`` at the bottom.

Cost models (``cost=``):

* ``"dram"`` (default) — off-chip DRAM elements moved. Span-local: every
  span pays its boundary io, one *read* per residual edge entering it
  from an earlier span, and one *write* per distinct interior source
  whose edge escapes the span. A source that is already DRAM-resident
  (the network input, or a map that IS a span boundary) pays only the
  re-read, never a second write — this mirrors the machine counters
  (``models.cnn.count_span_reads`` / ``count_span_writes``) exactly.
* ``"hops"`` — inter-stage link elements for pipeline placements: one
  hop per crossed boundary, each carrying the boundary map plus every
  distinct residual source live across that cut (=
  ``runtime.stap_pipeline.payload_spec(net, cut).elems``).

Both costs are additive over spans, so the optimum is a prefix DP:
``OPT(j) = min_a OPT(a) + C(a, j)`` over allowed spans — O(n^2) states,
milliseconds for ResNet-152.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol, Sequence

from .closure import max_tile_rows, span_footprint_elems
from .graph import NetSpec

INF = float("inf")


class PartitionProblem(Protocol):
    """What the DP needs to know about a layer chain."""

    @property
    def n_layers(self) -> int: ...

    def boundary_cost(self, i: int) -> float:
        """Off-chip elements moved when map L_i is a span input OR output
        (counted once per direction; a boundary between two spans costs
        write + read = 2x this)."""
        ...

    def span_fits(self, i: int, j: int) -> bool:
        """True if SPAN(i, j)'s footprint fits on-chip (Eqn. 1)."""
        ...

    def residual_edges(self) -> Sequence[tuple[int, int]]: ...

    def residual_cost(self, s: int) -> float:
        """Extra one-direction cost of spilling residual source map L_s."""
        ...


@dataclasses.dataclass
class Span:
    start: int
    end: int
    fits: bool  # False only for oversized single layers (lower-bound mode)


@dataclasses.dataclass
class PartitionResult:
    boundaries: list[int]  # interior partition points p_1 < ... < p_{k-1}
    spans: list[Span]
    transfers: float  # OPT(n) — optimal cost (dram elements, or hop elems)
    table_X: dict[tuple[int, int], float]   # prefix optima {(0, j): OPT(j)}
    table_p: dict[tuple[int, int], int | None]  # parent cuts {(0, j): a}

    @property
    def n_spans(self) -> int:
        return len(self.spans)


COST_MODES = ("dram", "hops")


def hop_payload(problem: PartitionProblem, p: int) -> float:
    """Elements carried by the pipeline hop at cut ``p``: the boundary
    map plus every *distinct* residual source live across the cut (each
    forwarded once per hop, however many sinks consume it) — the model
    twin of ``runtime.stap_pipeline.payload_spec(net, p).elems``."""
    srcs = {s for (s, t) in problem.residual_edges() if s < p < t}
    return problem.boundary_cost(p) + sum(problem.residual_cost(s)
                                          for s in srcs)


def span_local_cost(problem: PartitionProblem, a: int, b: int,
                    cost: str = "dram") -> float:
    """The cost a single span (a, b) contributes under ``cost`` —
    depends only on (a, b) and the global edge set, never on the other
    cuts, which is what makes the prefix DP exact.

    ``"dram"``: io at both ends, one *read* per edge entering from an
    earlier span (``s < a < t <= b`` — the machine re-reads per
    consuming edge), one *write* per distinct interior source whose
    edge escapes past ``b``. Sources at ``a``/``0``/any cut are already
    DRAM-resident (written as boundary io), so they pay no spill write.

    ``"hops"``: the payload of the hop at ``b`` (no hop after the last
    stage) — summing over spans gives one hop per crossed boundary.
    """
    n = problem.n_layers
    edges = problem.residual_edges()
    if cost == "hops":
        return hop_payload(problem, b) if b < n else 0.0
    if cost != "dram":
        raise ValueError(f"cost must be one of {COST_MODES}, got {cost!r}")
    total = problem.boundary_cost(a) + problem.boundary_cost(b)
    for (s, t) in edges:
        if s < a < t <= b:  # per-edge re-read of a spilled source
            total += problem.residual_cost(s)
    escaping = {s for (s, t) in edges if a < s < b and t > b}
    return total + sum(problem.residual_cost(s) for s in escaping)


def partition_cost(problem: PartitionProblem, cuts: Sequence[int],
                   cost: str = "dram") -> float:
    """Total cost of an explicit cut set (INF when a multi-layer span
    exceeds capacity). The model-side twin of the runtime counters; the
    DP minimizes exactly this."""
    pts = [0] + sorted(cuts) + [problem.n_layers]
    total = 0.0
    for a, b in zip(pts, pts[1:]):
        if not problem.span_fits(a, b) and b - a > 1:
            return INF
        total += span_local_cost(problem, a, b, cost)
    return total


def optimal_partition(problem: PartitionProblem,
                      cost: str = "dram") -> PartitionResult:
    """Prefix DP over span end points (paper Fig. 4, reformulated).

    Allowed spans: SPAN(a, j) fits, or has length 1 (the paper's
    lower-bound mode for single layers that exceed capacity — VGG's
    biggest layers). Recurrence::

        OPT(0) = 0
        OPT(j) = min over allowed (a, j) of OPT(a) + C(a, j)

    with ``C = span_local_cost`` (see there for the dram/hops cost
    semantics). Residual accounting is span-local — a spilled source is
    written once where it is produced and re-read once per consuming
    edge, and a source that is already DRAM-resident (the input, or a
    map sitting ON a partition boundary) pays only the read — so the
    objective is a well-defined function of the final PBS and the
    prefix decomposition is exact.
    """
    n = problem.n_layers
    if n == 0:
        raise ValueError("empty network")
    if cost not in COST_MODES:
        raise ValueError(f"cost must be one of {COST_MODES}, got {cost!r}")
    fits: dict[tuple[int, int], bool] = {}
    best: list[float] = [INF] * (n + 1)
    parent: list[int | None] = [None] * (n + 1)
    best[0] = 0.0
    for j in range(1, n + 1):
        for a in range(0, j):
            f = problem.span_fits(a, j)
            fits[(a, j)] = f
            if not (f or j - a == 1):
                continue
            cand = best[a] + span_local_cost(problem, a, j, cost)
            if cand < best[j]:
                best[j], parent[j] = cand, a

    boundaries: list[int] = []
    j = n
    while True:
        a = parent[j]
        if a is None or a == 0:
            break
        boundaries.append(a)
        j = a
    boundaries.reverse()
    cuts = [0] + boundaries + [n]
    spans = [Span(cuts[k], cuts[k + 1], fits[(cuts[k], cuts[k + 1])])
             for k in range(len(cuts) - 1)]
    table_x = {(0, j): best[j] for j in range(1, n + 1)}
    table_p = {(0, j): parent[j] for j in range(1, n + 1)}
    return PartitionResult(boundaries, spans, best[n], table_x, table_p)


# --------------------------------------------------------------------------
# CNN problem (the paper)
# --------------------------------------------------------------------------

_FP32_BYTES = 4.0  # the repo's elem-denominated reference width


@dataclasses.dataclass
class CNNPartitionProblem:
    """Paper §III-D: footprint = |DC(i,j)| + sum W, boundary = b * |L_i|.

    ``policy`` (optional, duck-typed — any object exposing
    ``activation_bytes`` / ``weight_bytes`` / ``boundary_bytes``, i.e. a
    ``repro.occam.quant.DtypePolicy``) makes both sides of the DP
    byte-denominated while keeping the units fp32-equivalent elements
    (bytes / 4), so ``capacity_elems`` and every serialized plan keep
    meaning what they always did:

    * footprints shrink by the activation/weight widths — an int8
      closure packs 4x the rows into the same VMEM, so the fits set
      grows and the chosen cuts genuinely move;
    * boundary and residual charges scale by the boundary width — the
      DP minimizes *bytes moved*, matching what a quantized boundary
      actually ships.

    ``policy=None`` is exactly the historical fp32 arithmetic (integral
    footprints, elem charges).
    """

    net: NetSpec
    capacity_elems: int
    batch: int = 1
    policy: object = None

    @property
    def n_layers(self) -> int:
        return self.net.n_layers

    def boundary_cost(self, i: int) -> float:
        elems = float(self.batch * self.net.map_elems(i))
        if self.policy is None:
            return elems
        return elems * self.policy.boundary_bytes / _FP32_BYTES

    def footprint(self, i: int, j: int) -> float:
        """fp(i, j): batch-scaled closure + chip-resident filters — the
        one definition of the DP's feasibility quantity (shared with
        :class:`PartitionSweep`'s memo). Feature-map closures scale with
        batch; filters are shared (Eqn. 6). Under a policy this is the
        byte footprint in fp32-equivalent elems."""
        from .closure import span_closure_elems

        closure = float(self.batch * span_closure_elems(self.net, i, j))
        weights = float(self.net.span_weight_elems(i, j))
        if self.policy is None:
            return closure + weights
        return (closure * self.policy.activation_bytes
                + weights * self.policy.weight_bytes) / _FP32_BYTES

    def span_fits(self, i: int, j: int) -> bool:
        return self.footprint(i, j) <= self.capacity_elems

    def residual_edges(self) -> Sequence[tuple[int, int]]:
        return self.net.residual_edges

    def residual_cost(self, s: int) -> float:
        elems = float(self.batch * self.net.map_elems(s))
        if self.policy is None:
            return elems
        return elems * self.policy.boundary_bytes / _FP32_BYTES


def partition_cnn(net: NetSpec, capacity_elems: int, batch: int = 1,
                  cost: str = "dram", policy: object = None) -> PartitionResult:
    return optimal_partition(
        CNNPartitionProblem(net, capacity_elems, batch, policy), cost)


def partition_transfers(net: NetSpec, boundaries: Sequence[int],
                        batch: int = 1, cost: str = "dram") -> float:
    """Canonical cost of an explicit CNN boundary set (capacity-free:
    feasibility is the caller's concern). This is THE model-side
    transfer formula — ``models.cnn.predicted_transfers`` and
    ``core.traffic.occam_traffic`` delegate here, so planning, serving
    accounting and serialized plans can never drift apart."""
    problem = CNNPartitionProblem(net, 0, batch)
    pts = [0] + sorted(boundaries) + [net.n_layers]
    return sum(span_local_cost(problem, a, b, cost)
               for a, b in zip(pts, pts[1:]))


def partition_report(net: NetSpec, capacity_elems: int, batch: int = 1) -> list[dict]:
    """Per-span report matching the paper's Table II columns:
    (p_begin, p_end, occam_tile_rows) + footprint split (Fig. 7)."""
    res = partition_cnn(net, capacity_elems, batch)
    rows = []
    for sp in res.spans:
        from .closure import max_square_tile, span_closure_elems

        rows.append({
            "start": sp.start,
            "end": sp.end,
            "fits": sp.fits,
            "occam_tile_rows": max_tile_rows(net, sp.start, sp.end,
                                             capacity_elems, batch),
            "lf_square_tile": max_square_tile(net, sp.start, sp.end,
                                              capacity_elems, batch),
            "closure_elems": span_closure_elems(net, sp.start, sp.end),
            "weight_elems": net.span_weight_elems(sp.start, sp.end),
        })
    return rows


# --------------------------------------------------------------------------
# Transformer problem (Occam C3 applied to pipeline-stage assignment)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TransformerPartitionProblem:
    """Occam's DP with an HBM cost model for decoder stacks.

    layer_weight_bytes[l]   : parameter (+optimizer-state) bytes of layer l
    boundary_act_bytes      : activation bytes crossing any layer boundary
                              (B x S x d_model x dtype) — uniform in a
                              homogeneous stack, so the DP optimizes *where*
                              capacity forces cuts (heterogeneous layers —
                              MoE vs Mamba vs attn — make boundaries cheap or
                              expensive via working-set differences).
    stage_capacity_bytes    : per-mesh-slice HBM budget
    layer_act_bytes[l]      : residency (KV cache / SSM state / remat stash)
                              of layer l that must live on the stage.
    residual (s, t) edges model long skips (e.g. speculative exits); none for
    the assigned archs' plain pre-norm residuals (those stay inside a layer).
    """

    layer_weight_bytes: Sequence[float]
    layer_act_bytes: Sequence[float]
    boundary_act_bytes: float
    stage_capacity_bytes: float
    edges: Sequence[tuple[int, int]] = ()

    @property
    def n_layers(self) -> int:
        return len(self.layer_weight_bytes)

    def boundary_cost(self, i: int) -> float:
        return float(self.boundary_act_bytes)

    def span_fits(self, i: int, j: int) -> bool:
        fp = sum(self.layer_weight_bytes[i:j]) + sum(self.layer_act_bytes[i:j])
        return fp <= self.stage_capacity_bytes

    def residual_edges(self) -> Sequence[tuple[int, int]]:
        return self.edges

    def residual_cost(self, s: int) -> float:
        return float(self.boundary_act_bytes)


def partition_transformer(layer_weight_bytes: Sequence[float],
                          layer_act_bytes: Sequence[float],
                          boundary_act_bytes: float,
                          stage_capacity_bytes: float,
                          edges: Sequence[tuple[int, int]] = ()) -> PartitionResult:
    return optimal_partition(TransformerPartitionProblem(
        list(layer_weight_bytes), list(layer_act_bytes),
        boundary_act_bytes, stage_capacity_bytes, list(edges)))


# --------------------------------------------------------------------------
# Memoized capacity sweeps (fleet-aware planning — repro.occam.autoplan)
# --------------------------------------------------------------------------

class _TabulatedCNNProblem(CNNPartitionProblem):
    """CNN problem whose ``span_fits`` reads a sweep's footprint memo
    instead of re-walking dependence closures per capacity."""

    def __init__(self, sweep: "PartitionSweep", capacity_elems: int):
        super().__init__(sweep.net, capacity_elems, sweep.batch, sweep.policy)
        self._sweep = sweep

    def span_fits(self, i: int, j: int) -> bool:
        return self._sweep.footprint(i, j) <= self.capacity_elems


@dataclasses.dataclass(frozen=True)
class SweptPartition:
    """One point of a capacity sweep: the DP's optimum at this capacity."""

    capacity_elems: int
    result: PartitionResult


class PartitionSweep:
    """Memoized Occam DP sweep over on-chip capacities (one net, one batch).

    The DP depends on capacity only through ``span_fits``; the span
    footprints ``fp(i, j) = batch * |DC(i, j)| + sum W`` are themselves
    capacity-independent. A fleet-aware planner sweeping many capacities
    therefore shares ONE footprint table (the O(n^3) closure walks)
    across the whole sweep instead of re-deriving it per capacity, and
    the DP re-runs only when the *fits set* actually changes.

    Two more exact prunes keep the sweep cheap:

    * ``candidate_capacities`` — the DP result is constant between
      consecutive distinct footprint values, so only those thresholds
      (<= the fleet's vmem) are ever evaluated.
    * ``sweep`` bisects the threshold list: transfers(C) is
      non-increasing in C, and a partition optimal at both ends of an
      interval with *equal* cost stays feasible (its spans still fit at
      any larger capacity) and hence optimal throughout — the interior
      fills without running the DP.
    """

    def __init__(self, net: NetSpec, batch: int = 1, policy: object = None):
        self.net = net
        self.batch = batch
        self.policy = policy
        self._problem = CNNPartitionProblem(net, 0, batch, policy)  # formula owner
        self._fp: dict[tuple[int, int], float] = {}
        self._results: dict[tuple[int, str], PartitionResult] = {}
        self._by_fits: dict[tuple[frozenset, str], PartitionResult] = {}
        self.dp_runs = 0           # DPs actually executed (memo diagnostics)
        self.dp_runs_by_cost: dict[str, int] = {}

    def footprint(self, i: int, j: int) -> float:
        """``CNNPartitionProblem.footprint`` (the one definition of the
        DP's feasibility quantity), memoized across the whole sweep."""
        key = (i, j)
        fp = self._fp.get(key)
        if fp is None:
            fp = self._problem.footprint(i, j)
            self._fp[key] = fp
        return fp

    def candidate_capacities(self, vmem_elems: int) -> list[int]:
        """The finite set of capacities that matter under ``vmem_elems``:
        the distinct span footprints <= vmem, ascending (the DP's fits
        set — hence its result — is constant between consecutive
        thresholds). When no span fits at all, ``[vmem_elems]`` (the DP
        still partitions, in per-layer lower-bound mode)."""
        n = self.net.n_layers
        # ceil, not trunc: a policy-scaled footprint can be fractional,
        # and the threshold must be the smallest *integer* capacity the
        # span fits at (identical to int() for the fp32 integral case)
        caps = sorted({math.ceil(self.footprint(i, j))
                       for i in range(n) for j in range(i + 1, n + 1)
                       if self.footprint(i, j) <= vmem_elems})
        return caps or [int(vmem_elems)]

    def partition_at(self, capacity_elems: int,
                     cost: str = "dram") -> PartitionResult:
        """The optimal partition at one capacity (memoized twice: by
        (capacity, cost) and by fits-set signature, so capacities
        between the same thresholds never re-run the DP)."""
        res = self._results.get((capacity_elems, cost))
        if res is not None:
            return res
        n = self.net.n_layers
        fits = frozenset((i, j) for i in range(n)
                         for j in range(i + 1, n + 1)
                         if self.footprint(i, j) <= capacity_elems)
        res = self._by_fits.get((fits, cost))
        if res is None:
            res = optimal_partition(_TabulatedCNNProblem(self,
                                                         capacity_elems),
                                    cost)
            self.dp_runs += 1
            self.dp_runs_by_cost[cost] = self.dp_runs_by_cost.get(cost, 0) + 1
            self._by_fits[(fits, cost)] = res
        self._results[(capacity_elems, cost)] = res
        return res

    def _refit(self, res: PartitionResult,
               capacity_elems: int) -> PartitionResult:
        """Re-evaluate per-span ``fits`` flags at another capacity (the
        cuts and transfer count carry over unchanged — an oversized
        single layer's lower bound equals its cost once it fits, which
        is exactly why the bisection fill is transfer-exact — but the
        flags drive engine routing and must reflect the new capacity)."""
        spans = [Span(sp.start, sp.end,
                      self.footprint(sp.start, sp.end) <= capacity_elems)
                 for sp in res.spans]
        if all(a.fits == b.fits for a, b in zip(spans, res.spans)):
            return res
        return PartitionResult(list(res.boundaries), spans, res.transfers,
                               res.table_X, res.table_p)

    def sweep(self, vmem_elems: int,
              cost: str = "dram") -> list[SweptPartition]:
        """Optimal partitions at every candidate capacity <= vmem."""
        caps = self.candidate_capacities(vmem_elems)
        out: list[PartitionResult | None] = [None] * len(caps)
        out[0] = self.partition_at(caps[0], cost)
        out[-1] = self.partition_at(caps[-1], cost)

        def refine(lo: int, hi: int) -> None:
            if hi - lo < 2:
                return
            a, b = out[lo], out[hi]
            if a.transfers == b.transfers:
                # a's spans fit at caps[lo], hence at every larger
                # capacity, and transfers(C) is non-increasing — a is
                # optimal on the whole interval. Fill without the DP.
                for k in range(lo + 1, hi):
                    out[k] = self._refit(a, caps[k])
                    self._results.setdefault((caps[k], cost), out[k])
                return
            mid = (lo + hi) // 2
            out[mid] = self.partition_at(caps[mid], cost)
            refine(lo, mid)
            refine(mid, hi)

        refine(0, len(caps) - 1)
        return [SweptPartition(c, r) for c, r in zip(caps, out)]


# --------------------------------------------------------------------------
# Reference implementations for testing optimality
# --------------------------------------------------------------------------

def brute_force_partition(problem: PartitionProblem,
                          cost: str = "dram") -> tuple[float, list[int]]:
    """Exponential enumeration of all PBSs (Layer Fusion's search) — used in
    tests to prove the DP optimal on small nets. O(2^(n-1)). Scores each
    cut set with the same :func:`partition_cost` the DP minimizes."""
    n = problem.n_layers
    best = (INF, [])
    for mask in range(1 << (n - 1)):
        cuts = [p for p in range(1, n) if mask >> (p - 1) & 1]
        c = partition_cost(problem, cuts, cost)
        if c < best[0]:
            best = (c, cuts)
    return best

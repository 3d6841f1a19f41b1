"""Plan-level invariants: document schema (OCM00x), closure residency
and capacity (OCM01x), DP cut optimality (OCM02x).

Every check here calls the *same* repo function the planner/runtime
uses — ``CNNPartitionProblem.span_fits``, ``closure.span_schedule``,
``partition_cost`` — rather than re-deriving the math, which is what
makes the zero-false-positive guarantee hold: a plan the planner can
emit replays bit-identically through these checks.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core import closure
from repro_torch.core.partition import (COST_MODES, CNNPartitionProblem,
                                  brute_force_partition, partition_cost)

from .report import ERROR, WARN, Finding, finding

# brute-force enumeration is O(2^(n-1)) partition_cost evaluations;
# at or below this layer count the exact optimum check (OCM021)
# replaces the single-boundary-move neighborhood check (OCM020)
BRUTE_FORCE_MAX_LAYERS = 12


def _tol(x: float) -> float:
    return max(1e-6, 1e-9 * abs(x))


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= _tol(max(abs(a), abs(b)))


def _improves(candidate: float, base: float) -> bool:
    """Strictly better beyond float noise. An infinite base (a cut set
    with a non-fitting multi-layer span) is improved by anything
    finite."""
    if base == float("inf"):
        return candidate < base
    return candidate < base - _tol(base)


class _MemoProblem:
    """Footprint-memoized view of a :class:`CNNPartitionProblem`.

    The optimality audit replays ``partition_cost`` over every
    single-boundary edit of the cut set, so each span's footprint is
    consulted many times; the base dataclass recomputes it from the
    closure each call.
    """

    def __init__(self, base: CNNPartitionProblem):
        self._base = base
        self._fp: dict[tuple[int, int], float] = {}
        self.capacity_elems = base.capacity_elems

    @property
    def n_layers(self) -> int:
        return self._base.n_layers

    def boundary_cost(self, i: int) -> float:
        return self._base.boundary_cost(i)

    def footprint(self, i: int, j: int) -> float:
        key = (i, j)
        if key not in self._fp:
            self._fp[key] = self._base.footprint(i, j)
        return self._fp[key]

    def span_fits(self, i: int, j: int) -> bool:
        return self.footprint(i, j) <= self.capacity_elems

    def residual_edges(self):
        return self._base.residual_edges()

    def residual_cost(self, s: int) -> float:
        return self._base.residual_cost(s)


def problem_for(plan) -> _MemoProblem:
    """The exact DP problem the plan claims to solve: same net, same
    capacity, same batch, same dtype policy."""
    return _MemoProblem(CNNPartitionProblem(
        plan.net, plan.capacity_elems, plan.batch, plan.quant))


# -- OCM00x: document schema ------------------------------------------------

def document_findings(d: dict, locus: str) -> list[Finding]:
    """OCM001 for plan/frontier documents: keys outside the stamped
    schema version's key set. Mirrors the strict loaders (which raise
    only on current-version documents) for old-stamped documents."""
    from ..plan import PLAN_KEYS_BY_VERSION
    from ..search import FRONTIER_DOCUMENT_KEYS

    out: list[Finding] = []
    version = d.get("version")
    if "candidates" in d or "objective" in d:
        known, label = FRONTIER_DOCUMENT_KEYS, "frontier"
    else:
        known = PLAN_KEYS_BY_VERSION.get(version)
        label = "plan"
        if known is None:
            return out  # unreadable version: the loader (OCM002) owns it
    for key in sorted(set(d) - set(known)):
        # a null-valued stray key cannot change behavior (loaders treat
        # null as absent) — flag it, but do not fail the audit over it
        severity = ERROR if d[key] is not None else WARN
        out.append(Finding(
            "OCM001", severity, locus,
            f"{label} document stamped version {version!r} carries "
            f"top-level key {key!r} outside its schema "
            f"({'non-null' if d[key] is not None else 'null'})",
            {"key": key, "version": version}))
    return out


# -- OCM01x: closure residency + capacity -----------------------------------

def _structure_findings(plan, locus: str) -> list[Finding]:
    """OCM002 when the span table does not tile the layer range implied
    by the boundaries — per-span checks would audit fiction."""
    n = plan.net.n_layers
    cuts = [0] + sorted(plan.boundaries) + [n]
    expected = list(zip(cuts[:-1], cuts[1:]))
    actual = [(sp.start, sp.end) for sp in plan.partition.spans]
    if actual == expected:
        return []
    return [finding(
        "OCM002", locus,
        f"span table {actual} does not tile the {n}-layer range cut at "
        f"{sorted(plan.boundaries)} (expected {expected})",
        spans=actual, expected=expected)]


def capacity_findings(plan, locus: str,
                      problem: _MemoProblem | None = None) -> list[Finding]:
    """OCM010/OCM011/OCM012: re-prove each span's streaming schedule and
    recheck the recorded fits flag against the capacity, both under the
    plan's quant block (byte-denominated footprints when a policy is
    set, Eqn. 1)."""
    net = plan.net
    problem = problem or problem_for(plan)
    n = net.n_layers
    boundaries = sorted(plan.boundaries)
    crossing = [(s, t) for (s, t) in net.residual_edges
                if any(s < p < t for p in boundaries)]
    spill_sources = {s for (s, _t) in crossing}
    out: list[Finding] = []
    for sp in plan.partition.spans:
        a, b = sp.start, sp.end
        span_locus = f"{locus}.span[{a}:{b}]"
        if not (0 <= a < b <= n):
            out.append(finding(
                "OCM010", span_locus,
                f"span range [{a}, {b}) is not a valid layer range of "
                f"the {n}-layer net; residency is unprovable",
                start=a, end=b, n_layers=n))
            continue
        fits = problem.span_fits(a, b)
        if sp.fits and not fits:
            fp = problem.footprint(a, b)
            out.append(finding(
                "OCM011", span_locus,
                f"span flagged fits=true but its footprint {fp:.0f} "
                f"fp32-equivalent elems exceeds the plan capacity "
                f"{plan.capacity_elems}",
                footprint=fp, capacity=plan.capacity_elems))
        elif not sp.fits and fits:
            out.append(finding(
                "OCM012", span_locus,
                f"span flagged fits=false but its footprint "
                f"{problem.footprint(a, b):.0f} fits the capacity "
                f"{plan.capacity_elems}; routing degrades to the oracle "
                f"lower bound",
                footprint=problem.footprint(a, b),
                capacity=plan.capacity_elems))
        if sp.fits:
            # residency re-proof: the same static schedule the engines
            # and pipeline stages build, at the plan's (clamped) tile
            # height with the partition's spill set
            t = max(1, min(plan.out_rows, net.map_shape(b)[0]))
            spill = tuple(sorted(m for m in spill_sources if a < m < b))
            try:
                closure.span_schedule(net, a, b, spill=spill, out_rows=t)
            except (AssertionError, ValueError, RuntimeError,
                    IndexError, KeyError) as e:
                out.append(finding(
                    "OCM010", span_locus,
                    f"closure residency proof failed at out_rows={t} "
                    f"spill={spill}: {e}",
                    out_rows=t, spill=list(spill), error=str(e)))
    return out


# -- OCM02x: DP cut optimality ----------------------------------------------

def _edits(cuts: Sequence[int], n: int):
    """Every single-boundary move of a cut set: drop one, add one, or
    shift one to any free position."""
    current = sorted(cuts)
    free = [p for p in range(1, n) if p not in set(current)]
    for c in current:
        rest = [x for x in current if x != c]
        yield ("drop", c, None), rest
        for p in free:
            yield ("shift", c, p), sorted(rest + [p])
    for p in free:
        yield ("add", None, p), sorted(current + [p])


def optimality_findings(plan, locus: str,
                        problem: _MemoProblem | None = None, *,
                        brute_force_max_layers: int = BRUTE_FORCE_MAX_LAYERS
                        ) -> list[Finding]:
    """OCM020/OCM021/OCM022: replay COST_MODES charges over the plan's
    cuts. The cost mode is not serialized (autoplan emits hop-cost plans,
    ``occam.plan`` dram-cost ones), so a plan passes when it is optimal
    under at least one mode."""
    problem = problem or problem_for(plan)
    cuts = sorted(plan.boundaries)
    n = problem.n_layers
    base = {m: partition_cost(problem, cuts, m) for m in COST_MODES}
    out: list[Finding] = []

    # OCM022: the recorded optimal-transfer count must replay from the
    # cuts under some mode (warn: a stale number misleads, it does not
    # execute)
    recorded = plan.partition.transfers
    if not any(_close(recorded, c) for c in base.values()):
        out.append(finding(
            "OCM022", locus,
            f"recorded transfers {recorded:g} replays under no cost "
            f"mode (got {', '.join(f'{m}={c:g}' for m, c in base.items())})",
            recorded=recorded,
            replayed={m: c for m, c in base.items()}))

    if n <= brute_force_max_layers:
        best = {m: brute_force_partition(problem, m) for m in COST_MODES}
        if not any(base[m] <= best[m][0] + _tol(best[m][0])
                   for m in COST_MODES):
            m = min(COST_MODES, key=lambda m: base[m] - best[m][0])
            out.append(finding(
                "OCM021", locus,
                f"cuts {cuts} are not the brute-force optimum under any "
                f"cost mode: {m} optimum is {best[m][1]} at "
                f"{best[m][0]:g} vs the plan's {base[m]:g}",
                cuts=cuts, mode=m, optimum=best[m][1],
                optimum_cost=best[m][0], plan_cost=base[m]))
        return out

    best_move = None
    for m in COST_MODES:
        improving = None
        for move, edited in _edits(cuts, n):
            c = partition_cost(problem, edited, m)
            if _improves(c, base[m]):
                improving = (move, edited, c)
                break
        if improving is None:
            return out  # locally optimal under this mode: plan passes
        if best_move is None or improving[2] < best_move[3]:
            best_move = (m, *improving)
    m, move, edited, c = best_move
    kind, src, dst = move
    out.append(finding(
        "OCM020", locus,
        f"a single-boundary move improves the plan under every cost "
        f"mode: {kind} {src if dst is None else (src, dst)} -> cuts "
        f"{edited} costs {c:g} vs {base[m]:g} under {m!r}",
        cuts=cuts, mode=m, move=kind, edited=edited,
        edited_cost=c, plan_cost=base[m]))
    return out


def plan_findings(plan, locus: str, *,
                  brute_force_max_layers: int = BRUTE_FORCE_MAX_LAYERS
                  ) -> list[Finding]:
    """All OCM00x/01x/02x findings for one plan."""
    structural = _structure_findings(plan, locus)
    if structural:
        # the span table is fiction relative to the cuts; deeper checks
        # would audit an inconsistent document
        return structural
    problem = problem_for(plan)
    out = capacity_findings(plan, locus, problem)
    if any(f.rule in ("OCM010", "OCM011") for f in out):
        # capacity/residency is broken: every edit of an infeasible cut
        # set "improves" it, so the optimality replay would only echo
        # the same root cause under a second rule ID
        return out
    out += optimality_findings(
        plan, locus, problem,
        brute_force_max_layers=brute_force_max_layers)
    return out

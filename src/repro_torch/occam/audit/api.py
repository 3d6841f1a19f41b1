"""``occam.audit`` — the dispatcher.

``audit(obj)`` accepts anything the staged API produces — a
:class:`~repro.occam.Plan`, :class:`~repro.occam.Placement`,
:class:`~repro.occam.Deployment`, :class:`~repro.occam.search.Candidate`,
:class:`~repro.occam.Frontier` — or a raw document (``dict``, JSON
path), and returns an :class:`AuditReport`. Pure static analysis: no
device code runs, no plan executes.

``gate(obj, mode)`` is the knob behind ``Plan.place(audit=...)`` /
``Placement.compile(audit=...)`` / ``Frontier.serve(audit=...)``:
``"error"`` raises :class:`AuditError` on error findings, ``"warn"``
(the default) emits an :class:`AuditWarning`, ``"off"`` skips.
"""
from __future__ import annotations

import json
import os
import warnings

from . import concurrency, invariants, routing, schedule
from .invariants import BRUTE_FORCE_MAX_LAYERS
from .report import ERROR, AuditReport, AuditWarning, Finding, finding

__all__ = ["audit", "gate", "audit_path", "AUDIT_MODES"]

AUDIT_MODES = ("error", "warn", "off")


def _plan_subject(plan) -> str:
    name = getattr(plan.net, "name", None) or "net"
    return f"plan[{name}@{plan.capacity_elems}]"


def _audit_plan(plan, locus: str, *, pipeline: bool = False,
                replicas=None, brute_force_max_layers: int
                ) -> list[Finding]:
    out = invariants.plan_findings(
        plan, locus, brute_force_max_layers=brute_force_max_layers)
    if not any(f.severity == ERROR for f in out):
        # routes only mean something over a structurally sound partition
        out += routing.routing_findings(plan, locus, pipeline=pipeline)
    if not any(f.rule == "OCM002" for f in out):
        # span counts are fiction when the span table does not tile
        out += schedule.serving_findings(plan, locus, replicas=replicas)
    return out


def _audit_candidate(cand, locus: str, fleet,
                     brute_force_max_layers: int) -> list[Finding]:
    from ..place import PIPELINE

    pipeline = cand.kind == PIPELINE
    out = _audit_plan(cand.plan, locus, pipeline=pipeline,
                      replicas=cand.replicas if pipeline else None,
                      brute_force_max_layers=brute_force_max_layers)
    out += schedule.chip_findings(cand.kind, cand.replicas, cand.chips,
                                  locus, fleet=fleet or cand.plan.fleet)
    if pipeline:
        geo = schedule.permute_findings(cand.replicas,
                                        cand.plan.n_spans, locus)
        out += geo
        if not geo:
            out += schedule.conveyor_findings(len(cand.replicas), locus)
    return out


def _audit_placement(placement, locus: str,
                     brute_force_max_layers: int) -> list[Finding]:
    from ..place import PIPELINE

    pipeline = placement.kind == PIPELINE
    replicas = tuple(placement.stap.replicas) if pipeline else None
    out = _audit_plan(placement.plan, locus, pipeline=pipeline,
                      replicas=replicas,
                      brute_force_max_layers=brute_force_max_layers)
    if pipeline:
        geo = schedule.permute_findings(replicas, placement.plan.n_spans,
                                        locus)
        out += geo
        if not geo:
            out += schedule.conveyor_findings(len(replicas), locus)
    return out


def _audit_document(d: dict, locus: str,
                    brute_force_max_layers: int) -> AuditReport:
    from ..plan import plan_from_dict
    from ..search import frontier_from_dict

    out = invariants.document_findings(d, locus)
    # strip the flagged stray keys so the strict loader does not raise
    # over what OCM001 already reports — the rest of the document still
    # gets the full audit
    stray = {f.detail.get("key") for f in out if f.rule == "OCM001"}
    clean = {k: v for k, v in d.items() if k not in stray}
    is_frontier = "candidates" in clean or "objective" in clean
    try:
        obj = frontier_from_dict(clean) if is_frontier \
            else plan_from_dict(clean)
    except Exception as e:
        out.append(finding(
            "OCM002", locus,
            f"document does not load as a "
            f"{'frontier' if is_frontier else 'plan'}: {e}",
            error=str(e)))
        return AuditReport(locus, tuple(out))
    inner = audit(obj, brute_force_max_layers=brute_force_max_layers)
    return AuditReport(locus, tuple(out) + inner.findings)


def audit(obj, *, brute_force_max_layers: int = BRUTE_FORCE_MAX_LAYERS
          ) -> AuditReport:
    """Statically verify a plan / placement / deployment / candidate /
    frontier / document -> :class:`AuditReport`.

    ``brute_force_max_layers``: nets at or below this many layers get
    the exact brute-force cut-optimality check (OCM021); larger nets
    the single-boundary-move neighborhood check (OCM020).
    """
    from ..deploy import Deployment
    from ..place import Placement
    from ..plan import Plan
    from ..search import Candidate, Frontier

    kw = {"brute_force_max_layers": brute_force_max_layers}
    if isinstance(obj, (str, os.PathLike)):
        return audit_path(os.fspath(obj), **kw)
    if isinstance(obj, dict):
        return _audit_document(obj, "document", **kw)
    if isinstance(obj, Plan):
        subject = _plan_subject(obj)
        return AuditReport(subject,
                           tuple(_audit_plan(obj, subject, **kw)))
    if isinstance(obj, Placement):
        subject = f"placement[{obj.kind}:{_plan_subject(obj.plan)}]"
        return AuditReport(subject,
                           tuple(_audit_placement(obj, subject, **kw)))
    if isinstance(obj, Deployment):
        subject = f"deployment[{obj.placement.kind}:" \
                  f"{_plan_subject(obj.placement.plan)}]"
        return AuditReport(
            subject, tuple(_audit_placement(obj.placement, subject, **kw)))
    if isinstance(obj, Candidate):
        subject = f"candidate[{obj.kind}:{_plan_subject(obj.plan)}]"
        return AuditReport(
            subject,
            tuple(_audit_candidate(obj, subject, obj.plan.fleet,
                                   brute_force_max_layers)))
    if isinstance(obj, Frontier):
        findings: list[Finding] = []
        for i, cand in enumerate(obj.candidates):
            findings += _audit_candidate(
                cand, f"frontier.candidate[{i}]", obj.fleet,
                brute_force_max_layers)
        return AuditReport(f"frontier[{len(obj.candidates)} candidates]",
                           tuple(findings))
    raise TypeError(
        f"occam.audit takes a Plan, Placement, Deployment, Candidate, "
        f"Frontier, document dict, or path; got {type(obj).__name__}")


def audit_path(path: str, *,
               brute_force_max_layers: int = BRUTE_FORCE_MAX_LAYERS
               ) -> AuditReport:
    """Audit a plan/frontier JSON artifact on disk."""
    with open(path) as f:
        try:
            d = json.load(f)
        except json.JSONDecodeError as e:
            return AuditReport(path, (finding(
                "OCM002", path, f"artifact is not JSON: {e}",
                error=str(e)),))
    if not isinstance(d, dict):
        return AuditReport(path, (finding(
            "OCM002", path,
            f"artifact is a JSON {type(d).__name__}, not a "
            f"plan/frontier document"),))
    return _audit_document(
        d, path, brute_force_max_layers=brute_force_max_layers)


def gate(obj, mode: str, *, what: str = "") -> AuditReport | None:
    """Apply the ``audit=`` knob: run the audit and enforce ``mode``."""
    if mode == "off":
        return None
    if mode not in AUDIT_MODES:
        raise ValueError(f"audit must be one of {AUDIT_MODES}, "
                         f"got {mode!r}")
    report = audit(obj)
    if mode == "error":
        report.raise_if_error()
    elif not report.ok:
        prefix = f"{what}: " if what else ""
        warnings.warn(f"{prefix}{report.summary()} "
                      f"(pass audit='error' to fail, audit='off' to "
                      f"skip)", AuditWarning, stacklevel=3)
    return report


# re-exported so ``from repro_torch.occam.audit.api import *`` users see the
# lint entry next to the dispatcher
lint_serve = concurrency.lint_serve

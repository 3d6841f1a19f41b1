"""``occam.audit`` — static plan/pipeline verifier and concurrency lint.

A pure, no-execution analyzer for everything the staged API ships:

* closure residency and capacity re-proofs per span (OCM01x),
* DP cut-optimality replay over ``COST_MODES`` (OCM02x),
* placement geometry — permute bijections, conveyor coverage, serving
  divisibility, chip accounting (OCM03x),
* engine-routing feasibility against the registry (OCM04x),
* an AST concurrency lint over ``occam/serve`` (OCM05x),
* document-schema checks mirroring the strict loaders (OCM00x).

Entry points: :func:`audit` (any staged object or JSON artifact ->
:class:`AuditReport`), :func:`lint_serve` (the serve-loop lint),
``python -m repro.occam.audit`` (the ``make audit`` CI gate). The
package-level name ``occam.audit`` is rebound to the :func:`audit`
function, mirroring ``occam.calibrate``.
"""
from .api import AUDIT_MODES, audit, audit_path, gate
from .concurrency import lint_file, lint_serve, lint_source, serve_root
from .invariants import BRUTE_FORCE_MAX_LAYERS
from .report import (AUDIT_FORMAT_VERSION, AUDIT_RULES, AuditError,
                     AuditReport, AuditWarning, Finding, Rule)

__all__ = [
    "AUDIT_FORMAT_VERSION", "AUDIT_MODES", "AUDIT_RULES",
    "AuditError", "AuditReport", "AuditWarning",
    "BRUTE_FORCE_MAX_LAYERS", "Finding", "Rule",
    "audit", "audit_path", "gate",
    "lint_file", "lint_serve", "lint_source", "serve_root",
]

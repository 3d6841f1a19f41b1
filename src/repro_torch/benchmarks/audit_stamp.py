"""Audit stamps for the port's benchmark documents, the twin of
``benchmarks/audit_stamp.py``.

Every ``results/BENCH_torch_*.json`` embeds the ``occam.audit`` verdict
of the planning artifact(s) the benchmark actually measured (the compact
``AuditReport.verdict()`` form: pass/fail + the rule signature), so a
reader can tell a number produced from a statically verified plan
apart from one measured off a stale or corrupted document.

``backfill`` stamps documents written before the auditor existed with
an explicit ``unaudited`` marker rather than leaving the key absent —
absence would be indistinguishable from "never considered". It reads
and writes only the port's ``BENCH_torch_*.json``: the reference's
``BENCH_*.json`` are never touched.
"""
from __future__ import annotations

import json
import os

UNAUDITED = {"ok": None, "rules": [],
             "note": "pre-audit artifact: re-run "
                     "`python -m repro_torch.benchmarks.run` to stamp"}
PREFIX = "BENCH_torch_"


def audit_verdict(*objects) -> dict:
    """Merged ``occam.audit`` verdict over the plans / placements /
    frontiers a benchmark measured."""
    from repro_torch.occam.audit.api import audit

    report = None
    for obj in objects:
        rep = audit(obj)
        report = rep if report is None else report.merged(rep)
    return report.verdict()


def backfill(results_dir: str) -> list[str]:
    """Add the ``unaudited`` stamp to every ``BENCH_torch_*.json`` under
    ``results_dir`` missing an ``audit`` key. Returns stamped paths."""
    stamped: list[str] = []
    if not os.path.isdir(results_dir):
        return stamped
    for name in sorted(os.listdir(results_dir)):
        if not (name.startswith(PREFIX) and name.endswith(".json")):
            continue
        path = os.path.join(results_dir, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(doc, dict) or "audit" in doc:
            continue
        doc["audit"] = dict(UNAUDITED)
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        stamped.append(path)
    return stamped

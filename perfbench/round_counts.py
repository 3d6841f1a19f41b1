"""Counts per image of a serving round, as the program puts them on its
``occam.session.round`` spans: ``weight_bytes``, the fused-span kernel's
count of the round's launches, and ``boundary_bytes``, the deployment's
per-image transfer profile. A program that puts no such attribute on its
rounds gives none, and the readers return None.
"""
from __future__ import annotations

ROUND = "occam.session.round"


def mean_mb(recs, attr: str) -> float | None:
    """The mean of ``attr`` over the round spans that carry it, in MB."""
    values = [r.attrs[attr] for r in recs if r.name == ROUND
              and r.attrs.get(attr) is not None]
    return sum(values) / len(values) / 1e6 if values else None

"""Frontier re-scoring under measured rates (``occam.calibrate``).

``autoplan`` scores every candidate with the fleet's analytic roofline.
Once :func:`~repro.occam.calibrate.cost_model.calibrate` has fitted a
:class:`~repro.occam.calibrate.cost_model.CostModel` from a live
deployment, :func:`rescore_frontier` re-ranks the SAME candidates under
the measured rates: each candidate's period / fill latency are recomputed
with the calibrated per-stage affine model and link rate, the Pareto set
is re-filtered, and a new :class:`~repro.occam.search.Frontier` comes
back sorted under the original objective. The DP never re-runs — the
partitions, placements, traffic predictions, and compiled deployment
caches all carry over; only the time axis moves.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from .cost_model import CostModel


def rescore_candidate(cand, cost_model: CostModel):
    """One candidate re-scored under measured rates.

    Mirrors the analytic scorer (``search._score``) with the calibrated
    model: stage MAC counts go through the affine ``t = macs/macs_per_s
    + overhead`` fit, boundary payloads through the measured link rate,
    and the single-chip HBM floor through the measured (or fleet) HBM
    rate. Traffic and chips are placement facts — they do not move.
    The returned candidate shares the original's deployment cache, so
    re-deploying a re-scored winner never recompiles.
    """
    from repro_torch.occam.place import SINGLE

    plan = cand.plan
    times_s = [cost_model.stage_seconds(m) for m in cand.stage_times]
    batch = plan.batch
    if cand.kind == SINGLE:
        period = sum(times_s)
        fill = batch * sum(times_s)
        hbm = cost_model.hbm_seconds(cand.traffic)
        period = max(period, hbm)
    else:
        bottleneck = max(t / r for t, r in zip(times_s, cand.replicas))
        period = bottleneck
        width = functools.reduce(math.lcm, cand.replicas, 1)
        fill = len(cand.replicas) * width * batch * bottleneck
        if cost_model.link_s_per_elem > 0:
            from repro_torch.runtime.stap_pipeline import payload_spec

            link = max((cost_model.hop_seconds(payload_spec(plan.net,
                                                            b).elems)
                        for b in plan.boundaries), default=0.0)
            period = max(period, link)
    return dataclasses.replace(
        cand, plan=plan.with_calibration(cost_model),
        period=period, fill_latency=fill)


def rescore_frontier(frontier, cost_model: CostModel):
    """A new frontier: every candidate re-scored under ``cost_model``,
    Pareto re-filtered, re-sorted under the frontier's objective.

    This is ``Frontier.rescore``'s implementation. The search never
    re-runs — no DP, no placement enumeration; candidates that fall off
    the Pareto set under measured rates are dropped, and each surviving
    candidate's plan carries the calibration (schema-v4 block), so a
    saved re-scored frontier ships its own measurement provenance.
    """
    from repro_torch.occam import search

    rescored = [rescore_candidate(c, cost_model)
                for c in frontier.candidates]
    pareto = [c for c in rescored
              if not any(search._dominates(o, c) for o in rescored)]
    pareto.sort(key=search._OBJECTIVE_KEYS[frontier.objective])
    stats = dict(frontier.stats)
    stats["rescored_from"] = len(frontier.candidates)
    stats["calibration"] = cost_model.to_dict()
    return search.Frontier(frontier.fleet, frontier.objective,
                           tuple(pareto),
                           arrival_rate=frontier.arrival_rate,
                           stats=stats)

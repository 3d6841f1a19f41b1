"""Staged Occam deployment API on PyTorch: ``autoplan`` / ``plan -> place
-> compile``.

The front door is fleet-aware: describe the hardware once and let the
planner derive capacity and placement, then re-rank on measurements::

    from repro_torch import occam

    fleet = occam.Fleet(chips=1, vmem_elems=3_145_728,
                        dtype_policy=("fp32", "int8", "bf16"))
    frontier = occam.autoplan(net, fleet)         # Pareto candidates
    frontier.save("resnet18.frontier.json")       # same schema as repro's

    dep = frontier.best("throughput").deploy()    # one GPU ("cuda")
    cm = occam.calibrate(dep, params)             # measured CostModel
    frontier = frontier.rescore(cm)               # re-ranked, no DP
    sess = dep.serve(params, round_batch=8)       # continuous serving
    sess = sess.scale(arrival_rate=rate)          # frontier-driven autoscale

    engine = frontier.serve(params, round_batch=8)   # async continuous
    ticket = await engine.submit(xs, tenant="alice") # batching: admission,
    y = await ticket                              # SLO flushes, live
                                                  # metrics, damped
                                                  # autoscaling (occam.serve)
    occam.audit(frontier).ok                      # static verification
    with torch.profiler.profile():                # the serving path's
        y = await (await engine.submit(xs))       # spans, kept while a
    occam.trace.records()                         # profiler records

``plan``/``place`` remain the low-level surface when you already know the
capacity you want::

    plan = occam.plan(net, capacity_elems)        # DP + engine routes
    plan.save("resnet18.plan.json")
    dep = plan.place().compile()                  # one GPU ("cuda")
    y = dep.run(params, xs)                       # numpy or tensors
    dep.report().matches_prediction               # model == machine

    plan8 = occam.plan(net, capacity_elems, dtype_policy="int8")
    with plan8.place().compile().serve(params, round_batch=8) as sess:
        t = sess.submit(xs)                       # any number of images
        (ticket, y), = sess.results()             # submit order

    dep = (plan.place(replicas=(4, 1, 1, 1, 1), microbatch=2)
               .compile(device="cuda:0"))         # STAP pipeline, every
    y = dep.run(params, xs)                       # position on one GPU
    sess = dep.serve(params, round_batch=8)       # ring sessions

Execution backends live in :mod:`repro_torch.occam.registry`; the span
engine registers the kernel (route name ``pallas``), ``scan``,
``oracle`` and ``interpreted`` engines at import, each but
``interpreted`` with a pipeline stage body.
"""
from . import quant, registry, serve, trace
from .deploy import Deployment, ServingStats, Session, Ticket
from .fleet import Fleet, load_fleet
from .place import PIPELINE, SINGLE, Placement
from .plan import (PLAN_FORMAT_VERSION, Plan, ServingDefaults, load_plan,
                   plan, plan_from_dict, plan_from_json)
from .quant import POLICIES, DtypePolicy, resolve_policies, resolve_policy
from .registry import (AUTO, BackendError, EngineSpec, RouteContext,
                       backend_names, get_engine, register_engine,
                       registered_engines, resolve_spmd_engine,
                       unregister_engine)
from .search import (FRONTIER_FORMAT_VERSION, OBJECTIVES, Candidate,
                     Frontier, autoplan, frontier_from_dict,
                     frontier_from_json, load_frontier)
from .serve import AdmissionError, AsyncEngine, AsyncTicket, Router
# measured-cost planning: the submodule stays importable as
# repro_torch.occam.calibrate; the package-level name ``occam.calibrate``
# is the entry-point FUNCTION (deployment -> CostModel)
from .calibrate import (ChipAssignment, CostModel, StageProfile,
                        TickTimers, pack_replicas, rescore_frontier)
from .calibrate.cost_model import calibrate
# static verification: the submodule stays importable as
# repro_torch.occam.audit; the package-level name ``occam.audit`` is the
# entry-point FUNCTION (plan/placement/deployment/frontier/artifact ->
# AuditReport)
from .audit import (AUDIT_RULES, AuditError, AuditReport, AuditWarning,
                    Finding, lint_serve)
from .audit.api import audit

__all__ = [
    "AUDIT_RULES", "AUTO", "FRONTIER_FORMAT_VERSION", "OBJECTIVES",
    "PIPELINE", "PLAN_FORMAT_VERSION", "POLICIES", "SINGLE",
    "AdmissionError", "AsyncEngine", "AsyncTicket",
    "AuditError", "AuditReport", "AuditWarning",
    "BackendError", "Candidate", "ChipAssignment", "CostModel",
    "Deployment", "DtypePolicy", "EngineSpec", "Finding", "Fleet",
    "Frontier", "Placement", "Plan", "RouteContext", "Router",
    "ServingDefaults", "ServingStats", "Session", "StageProfile",
    "TickTimers", "Ticket", "audit", "autoplan",
    "backend_names", "calibrate", "frontier_from_dict",
    "frontier_from_json", "get_engine", "lint_serve", "load_fleet",
    "load_frontier", "load_plan", "pack_replicas", "plan",
    "plan_from_dict", "plan_from_json", "quant", "register_engine",
    "registered_engines", "registry", "rescore_frontier",
    "resolve_policies", "resolve_policy",
    "resolve_spmd_engine", "serve", "trace", "unregister_engine",
]

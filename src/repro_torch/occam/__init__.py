"""Staged Occam deployment API on PyTorch: ``plan -> place -> compile``.

    from repro_torch import occam

    plan = occam.plan(net, capacity_elems)        # DP + engine routes
    plan.save("resnet18.plan.json")               # same schema as repro's
    dep = plan.place().compile()                  # one GPU ("cuda")
    y = dep.run(params, xs)                       # numpy or tensors
    dep.report().matches_prediction               # model == machine

    plan8 = occam.plan(net, capacity_elems, dtype_policy="int8")
    with plan8.place().compile().serve(params, round_batch=8) as sess:
        t = sess.submit(xs)                       # any number of images
        (ticket, y), = sess.results()             # submit order

Execution backends live in :mod:`repro_torch.occam.registry`; the span
engine registers the kernel (route name ``pallas``), ``scan``,
``oracle`` and ``interpreted`` engines at import.
"""
from . import quant, registry
from .deploy import Deployment, ServingStats, Session, Ticket
from .fleet import Fleet, load_fleet
from .place import SINGLE, Placement
from .plan import (PLAN_FORMAT_VERSION, Plan, ServingDefaults, load_plan,
                   plan, plan_from_dict, plan_from_json)
from .quant import POLICIES, DtypePolicy, resolve_policies, resolve_policy
from .registry import (AUTO, BackendError, EngineSpec, RouteContext,
                       backend_names, get_engine, register_engine,
                       registered_engines, unregister_engine)

__all__ = [
    "AUTO", "PLAN_FORMAT_VERSION", "POLICIES", "SINGLE",
    "BackendError", "Deployment", "DtypePolicy", "EngineSpec", "Fleet",
    "Placement", "Plan", "RouteContext", "ServingDefaults",
    "backend_names", "get_engine", "load_fleet", "load_plan", "plan",
    "plan_from_dict", "plan_from_json", "quant", "register_engine",
    "registered_engines", "registry", "resolve_policies", "resolve_policy",
    "ServingStats", "Session", "Ticket", "unregister_engine",
]

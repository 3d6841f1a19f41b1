"""Engine-routing feasibility (OCM04x).

Replays the registry's own admission logic over a plan's recorded
routes — the same ``_dtype_ok`` envelope test and ``accepts`` check
``route_span`` runs — so a forced or stale route fails at audit time
instead of compile time, and a pipeline placement knows every span can
actually produce an SPMD stage body.
"""
from __future__ import annotations

from ..registry import (BackendError, RouteContext, _dtype_ok, get_engine,
                        resolve_spmd_engine)
from .report import Finding, finding

__all__ = ["routing_findings"]


def routing_findings(plan, locus: str, *,
                     pipeline: bool = False) -> list[Finding]:
    """OCM040-043 for one plan's routes. ``pipeline=True`` additionally
    requires every routed engine to resolve an SPMD stage body (directly
    or through its ``spmd_fallback`` chain)."""
    net = plan.net
    out: list[Finding] = []

    expected = [(sp.start, sp.end) for sp in plan.partition.spans]
    actual = [(r.start, r.end) for r in plan.routes]
    if actual != expected:
        out.append(finding(
            "OCM042", locus,
            f"route table covers spans {actual}, not the partition's "
            f"{expected}; the routed engines would execute different "
            f"spans than the DP proved",
            routed=actual, expected=expected))
        return out

    fits = {(sp.start, sp.end): sp.fits for sp in plan.partition.spans}
    policy = plan.quant
    dtype = policy.compute if policy is not None else None
    for route in plan.routes:
        a, b = route.start, route.end
        span_locus = f"{locus}.span[{a}:{b}]"
        try:
            spec = get_engine(route.route)
        except BackendError as e:
            out.append(finding(
                "OCM040", span_locus,
                f"span routed to unregistered engine "
                f"{route.route!r}: {e}",
                engine=route.route))
            continue
        # the same per-span clamp plan_routes applies at planning time
        t = max(1, min(plan.out_rows, net.map_shape(b)[0]))
        ctx = RouteContext(fits=fits[(a, b)], out_rows=t, dtype=dtype)
        if not _dtype_ok(spec, ctx):
            out.append(finding(
                "OCM041", span_locus,
                f"span compute dtype {dtype!r} (policy "
                f"{getattr(policy, 'name', None) or 'fp32'!r}) is "
                f"outside engine {spec.name!r}'s envelope {spec.dtypes}",
                engine=spec.name, dtype=dtype,
                envelope=list(spec.dtypes or ())))
            continue
        ok, reason = spec.accepts(net, a, b, ctx)
        if not ok:
            out.append(finding(
                "OCM042", span_locus,
                f"engine {spec.name!r} rejects the span it is routed: "
                f"{reason}",
                engine=spec.name, reason=reason))
            continue
        if pipeline:
            try:
                resolve_spmd_engine(route.route)
            except BackendError as e:
                out.append(finding(
                    "OCM043", span_locus,
                    f"pipeline placement routes the span to "
                    f"{route.route!r}, which resolves no SPMD stage "
                    f"body: {e}",
                    engine=route.route))
    return out

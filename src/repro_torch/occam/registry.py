"""Span-engine registry: execution backends as registrations, not if/elif.

Every way of executing one DP span (the generated Pallas kernel, the jitted
row-streaming scan, the layer-by-layer oracle, the interpreted RowRing
specification — and whatever future PRs bring: real-TPU kernels,
continuous-stream serving bodies) registers an :class:`EngineSpec` here.
``repro.runtime.span_engine.plan_routes`` asks the registry to route each
span instead of hard-coding the dispatch, so a new backend is one
``register_engine`` call: it immediately participates in ``backend="auto"``
priority dispatch *and* becomes a valid forced ``backend=`` name for
``Placement.compile``.

An engine is two callables (plus an optional third for pipelines —
``make_spmd_body``, the stage-body builder the STAP pipeline dispatches
through; see :class:`EngineSpec`):

* ``accepts(net, a, b, ctx) -> (ok, reason)`` — pure eligibility check for
  SPAN(a, b). ``ctx`` carries partition-level facts (currently: whether the
  span's footprint fits on-chip). The reason string is kept on the
  resulting :class:`~repro.runtime.span_engine.SpanRoute` for diagnostics.
* ``run(params, net, a, b, stored, spill, *, interpret) -> (out, spilled)``
  — execute the span on a batch: ``stored`` maps feature-map index ->
  (B, h, w, c) array (span input + any DRAM-resident residual sources),
  ``spill`` lists interior maps that must be materialized for downstream
  spans. Returns the span output and a ``{map -> array}`` dict of spills.

``auto`` dispatch tries engines in ascending ``priority`` and takes the
first that accepts; forcing ``backend=<name>`` bypasses priority but still
honors ``accepts`` (a span the engine cannot run raises
:class:`BackendError` rather than silently running elsewhere).

This module is intentionally dependency-free (no jax, no repro.runtime)
so engines anywhere in the codebase can import it without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

AUTO = "auto"


class BackendError(ValueError):
    """A forced backend cannot take a span (or does not exist)."""


@dataclasses.dataclass(frozen=True)
class RouteContext:
    """Partition-level facts an ``accepts`` check may need."""

    fits: bool = True  # False only for oversized single layers (lower bound)
    out_rows: int = 1  # requested output tile height (rows per step)
    dtype: str | None = None  # activation dtype name when known at planning


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    priority: int              # ascending try-order under backend="auto"
    accepts: Callable[..., tuple[bool, str]]
    run: Callable[..., tuple]
    description: str = ""
    # Can this engine's span body trace under shard_map (drive a pipeline
    # placement stage)? Python-loop or real-hardware-only engines say no.
    spmd_capable: bool = False
    # Builder for the engine's SPMD pipeline stage body:
    # ``make_spmd_body(net, a, b, spill, src_keys, *, out_rows=1) -> body``
    # where ``body(span_params, x, srcs) -> (out, {map -> spilled})``
    # traces under shard_map (span_params: the span's own parameter
    # slices; x: (mb, h, w, c) span input; srcs: upstream residual
    # sources in ``src_keys`` order; out_rows: output tile height the
    # placement planned). The builder runs once at pipeline build time so
    # it may precompute static schedules. ``None`` means this engine has
    # no SPMD body of its own — ``spmd_fallback`` names the engine whose
    # body executes its spans in a pipeline (chains allowed).
    make_spmd_body: Callable | None = None
    spmd_fallback: str | None = None
    # Activation dtype names this engine's span body can execute
    # (``None``: any). Checked by ``route_span`` before ``accepts`` —
    # auto dispatch skips a non-matching engine, a forced backend raises
    # — so an engine declares its width envelope once instead of every
    # ``accepts`` re-implementing the same dtype test.
    dtypes: tuple[str, ...] | None = None


def resolve_spmd_engine(name: str) -> "EngineSpec":
    """The engine whose SPMD body actually executes spans routed to
    ``name`` in a pipeline: ``name`` itself if it registered a body
    builder, else its declared ``spmd_fallback`` (chains allowed).
    Raises :class:`BackendError` when the chain dead-ends — a span routed
    there cannot drive a pipeline stage."""
    seen: list[str] = []
    spec = get_engine(name)
    while spec.make_spmd_body is None:
        seen.append(spec.name)
        if spec.spmd_fallback is None or spec.spmd_fallback in seen:
            raise BackendError(
                f"engine {name!r} has no SPMD stage body (fallback chain "
                f"{seen!r}); register it with make_spmd_body= or "
                f"spmd_fallback= to run in a pipeline")
        spec = get_engine(spec.spmd_fallback)
    return spec


_ENGINES: dict[str, EngineSpec] = {}


def register_engine(name: str, *, priority: int,
                    accepts: Callable[..., tuple[bool, str]],
                    run: Callable[..., tuple],
                    description: str = "",
                    spmd_capable: bool = False,
                    make_spmd_body: Callable | None = None,
                    spmd_fallback: str | None = None,
                    dtypes: tuple[str, ...] | None = None,
                    overwrite: bool = False) -> EngineSpec:
    """Register (or, with ``overwrite=True``, replace) a span engine."""
    if name == AUTO:
        raise ValueError(f"{AUTO!r} is the dispatch mode, not an engine name")
    if name in _ENGINES and not overwrite:
        raise ValueError(f"engine {name!r} already registered "
                         "(pass overwrite=True to replace it)")
    spec = EngineSpec(name, priority, accepts, run, description,
                      spmd_capable, make_spmd_body, spmd_fallback,
                      tuple(dtypes) if dtypes is not None else None)
    _ENGINES[name] = spec
    return spec


def unregister_engine(name: str) -> None:
    _ENGINES.pop(name, None)


def get_engine(name: str) -> EngineSpec:
    try:
        return _ENGINES[name]
    except KeyError:
        raise BackendError(
            f"unknown engine {name!r}; registered: {sorted(_ENGINES)}"
        ) from None


def registered_engines() -> tuple[EngineSpec, ...]:
    """All engines, in auto-dispatch (ascending priority) order."""
    return tuple(sorted(_ENGINES.values(),
                        key=lambda e: (e.priority, e.name)))


def backend_names() -> tuple[str, ...]:
    return (AUTO,) + tuple(e.name for e in registered_engines())


def route_span(net, a: int, b: int, ctx: RouteContext | None = None, *,
               backend: str = AUTO) -> tuple[str, str]:
    """Pick the engine for SPAN(a, b) -> (engine name, reason).

    ``backend="auto"``: first accepting engine in priority order.
    ``backend=<name>``: that engine, or BackendError if it rejects.
    """
    ctx = ctx or RouteContext()
    if backend != AUTO:
        spec = get_engine(backend)
        if not _dtype_ok(spec, ctx):
            raise BackendError(
                f"backend {backend!r} cannot take span ({a}, {b}): dtype "
                f"{ctx.dtype!r} unsupported (declares {spec.dtypes})")
        ok, reason = spec.accepts(net, a, b, ctx)
        if not ok:
            raise BackendError(
                f"backend {backend!r} cannot take span ({a}, {b}): {reason}")
        return spec.name, reason
    for spec in registered_engines():
        if not _dtype_ok(spec, ctx):
            continue
        ok, reason = spec.accepts(net, a, b, ctx)
        if ok:
            return spec.name, reason
    raise BackendError(f"no registered engine accepts span ({a}, {b})")


def _dtype_ok(spec: EngineSpec, ctx: RouteContext) -> bool:
    """Does the engine's declared width envelope admit the span's dtype?"""
    return (ctx.dtype is None or spec.dtypes is None
            or ctx.dtype in spec.dtypes)

"""Span execution engine: route a DP partition to engines and run it.

Takes a :class:`~repro_torch.core.partition.PartitionResult` (or a raw
boundary list) and executes the net span by span on a batch of images.
Engines live in the deployment registry (``repro_torch.occam.registry``);
this module registers the four built-in ones at import, under the route
names that plan documents record:

* ``pallas`` (:data:`ROUTE_KERNEL`) — the fused-span kernel
  (``repro_torch.kernels.fused_span``). The name is plan-schema
  vocabulary kept from the reference, whose kernel was a Pallas kernel;
  here a CUDA batch runs the hand-written CUDA kernel and a CPU batch its
  plain PyTorch version. Conv/pool spans, any per-layer k / stride /
  same-padding, residual edges (in-span adds, sources crossing in from
  device memory, spills of partition-crossing sources), multi-row output
  tiles (``out_rows``).
* ``scan`` — the row-streaming loop over the span's static schedule
  (``repro_torch.models.cnn.span_scan``), the kernel's plain version
  (forced-backend / A-B reference).
* ``oracle`` — layer-by-layer execution for oversized single layers (the
  DP's lower-bound spans) or spans whose schedule fails validation.
* ``interpreted`` — the per-row RowRing loop (the executable
  specification); never auto-selected, available as a forced backend.

Off-chip traffic is accounted per span boundary (model == machine: totals
equal ``predicted_transfers`` x batch), whichever engine ran the span.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch.core import closure
from repro_torch.core.graph import NetSpec
from repro_torch.core.partition import PartitionResult
from repro_torch.kernels.fused_span import ops as span_ops
from repro_torch.models import cnn
from repro_torch.occam import registry

ROUTE_KERNEL = "pallas"
ROUTE_SCAN = "scan"
ROUTE_ORACLE = "oracle"
ROUTE_INTERPRETED = "interpreted"


@dataclasses.dataclass(frozen=True)
class SpanRoute:
    start: int
    end: int
    route: str
    reason: str


def _boundaries_of(partition: PartitionResult | Sequence[int],
                   net: NetSpec) -> list[int]:
    if isinstance(partition, PartitionResult):
        return list(partition.boundaries)
    return list(partition)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the registry's dtype names."""
    return str(dtype).removeprefix("torch.")


def plan_routes(net: NetSpec,
                partition: PartitionResult | Sequence[int], *,
                backend: str = registry.AUTO, out_rows: int = 1,
                dtype: str | None = None) -> tuple[SpanRoute, ...]:
    """Decide per-span engine. Pure function of the net + partition.

    ``backend``: ``"auto"`` (priority dispatch over the registry) or a
    registered engine name to force every span onto it (BackendError if
    any span is ineligible).
    ``out_rows``: requested output tile height (rows per step), clamped
    per span to its output height; engines whose schedule cannot retain
    the closure at that height reject.
    ``dtype``: activation dtype name, when known at planning time.
    """
    boundaries = _boundaries_of(partition, net)
    cuts = [0] + boundaries + [net.n_layers]
    fits = {(sp.start, sp.end): sp.fits for sp in partition.spans} \
        if isinstance(partition, PartitionResult) else {}
    routes = []
    for a, b in zip(cuts, cuts[1:]):
        t = max(1, min(out_rows, net.map_shape(b)[0]))
        ctx = registry.RouteContext(fits=fits.get((a, b), True),
                                    out_rows=t, dtype=dtype)
        name, reason = registry.route_span(net, a, b, ctx, backend=backend)
        routes.append(SpanRoute(a, b, name, reason))
    return tuple(routes)


def span_spills(net: NetSpec, boundaries: Sequence[int], a: int,
                b: int) -> tuple[int, ...]:
    """Interior maps of SPAN(a, b) that source a residual edge crossing a
    partition boundary: the span writes them out for a later span."""
    return tuple(sorted({s for (s, t) in net.residual_edges
                         if a < s < b and any(s < p < t
                                              for p in boundaries)}))


def execute_partition(params: list[dict], xs: torch.Tensor, net: NetSpec,
                      partition: PartitionResult | Sequence[int], *,
                      counter: cnn.TrafficCounter | None = None,
                      routes: tuple[SpanRoute, ...] | None = None,
                      out_rows: int = 1, policy=None) -> torch.Tensor:
    """Execute ``net`` on ``xs`` ((B, H, W, C) or (H, W, C)) span by span.

    ``params`` and ``xs`` must already be on one device; each engine runs
    on that device. ``counter`` accumulates off-chip element transfers
    (x batch), matching ``cnn.predicted_transfers(net, boundaries) *
    batch``; under a policy the byte twins scale by the boundary width.
    ``out_rows``: output tile height per step (Eqn. 6).
    ``policy``: an ``occam.quant.DtypePolicy`` — every map that crosses a
    span boundary (the input, span outputs, spills, residual sources)
    makes the round trip through the policy's boundary dtype before the
    next span reads it, and the weights through the weight dtype. The
    buffers stay fp32 (``fake_quant`` keeps its input's dtype), so span
    bodies run the engines' fp32 path on quantized values;
    ``policy.compute`` only chooses the routes.
    """
    squeeze = xs.ndim == 3
    if squeeze:
        xs = xs[None]
    batch = xs.shape[0]
    if policy is not None and policy.is_default:
        policy = None
    if policy is None:
        boundary = lambda t: t  # noqa: E731
        bpe = 4.0
    else:
        from repro_torch.occam.quant import casting

        params = casting.quantize_params(params, policy)
        boundary = functools.partial(casting.fake_quant,
                                     dtype=policy.boundary,
                                     scale=policy.scale)
        bpe = policy.boundary_bytes
    boundaries = _boundaries_of(partition, net)
    routes = routes or plan_routes(
        net, partition, out_rows=out_rows,
        dtype=policy.compute if policy is not None else dtype_name(xs.dtype))
    stored: dict[int, torch.Tensor] = {0: boundary(xs)}
    for route in routes:
        a, b = route.start, route.end
        cnn.count_span_reads(counter, net, a, b, batch, bytes_per_elem=bpe)
        spill = span_spills(net, boundaries, a, b)
        engine = registry.get_engine(route.route)
        t = max(1, min(out_rows, net.map_shape(b)[0]))  # per-span clamp
        out, spilled = engine.run(params, net, a, b, stored, spill,
                                  out_rows=t)
        cnn.count_span_writes(counter, net, b, spilled, batch,
                              bytes_per_elem=bpe)
        stored[b] = boundary(out)
        stored.update({m: boundary(v) for m, v in spilled.items()})
    y = stored[net.n_layers]
    return y[0] if squeeze else y


# --------------------------------------------------------------------------
# Built-in engines: eligibility checks
# --------------------------------------------------------------------------

def _oversized(net: NetSpec, a: int, b: int,
               ctx: registry.RouteContext) -> bool:
    """The DP's lower-bound case: a single layer that exceeds capacity."""
    return not ctx.fits and b - a == 1


# Activation dtypes the kernel's row math supports (fp32 accumulation;
# integer activations would silently change ReLU and pooling semantics).
_KERNEL_DTYPES = ("float32", "bfloat16", "float16")


def _tile_shape_reason(net: NetSpec, a: int, b: int,
                       out_rows: int) -> str | None:
    """Named tile-shape disqualifier for SPAN(a, b) at ``out_rows``, or
    None when the requested tile height is representable."""
    if out_rows < 1:
        return f"tile shape: out_rows={out_rows} (must be >= 1)"
    out_h = net.map_shape(b)[0]
    if out_rows > out_h:
        return (f"tile shape: out_rows={out_rows} exceeds span output "
                f"height {out_h}")
    return None


def _kernel_accepts(net: NetSpec, a: int, b: int,
                    ctx: registry.RouteContext) -> tuple[bool, str]:
    """Kernel eligibility. Rejections name the specific disqualifier —
    the BackendError a forced ``backend="pallas"`` raises carries it.
    Ring size is no disqualifier: the rings live in a device-memory
    workspace sized by the closure, whatever its size."""
    if _oversized(net, a, b, ctx):
        return False, "oversized single layer (lower bound)"
    bad_tile = _tile_shape_reason(net, a, b, ctx.out_rows)
    if bad_tile:
        return False, bad_tile
    touched = [(s, t) for (s, t) in net.residual_edges
               if a < t <= b or a < s < b]
    try:
        closure.span_schedule(net, a, b, out_rows=ctx.out_rows)
    except (AssertionError, RuntimeError) as e:
        kind = f"residual edges {touched}: " if touched else ""
        return False, (f"schedule rejected at out_rows={ctx.out_rows}: "
                       f"{kind}{e}")
    if touched:
        return True, f"fused span kernel (residual edges {touched})"
    return True, "fused span kernel"


def _scan_accepts(net: NetSpec, a: int, b: int,
                  ctx: registry.RouteContext) -> tuple[bool, str]:
    if _oversized(net, a, b, ctx):
        return False, "oversized single layer (lower bound)"
    bad_tile = _tile_shape_reason(net, a, b, ctx.out_rows)
    if bad_tile:
        return False, bad_tile
    touched = [(s, t) for (s, t) in net.residual_edges
               if a < t <= b or a < s < b]
    try:
        closure.span_schedule(net, a, b, out_rows=ctx.out_rows)
    except (AssertionError, RuntimeError) as e:
        return False, f"schedule rejected at out_rows={ctx.out_rows}: {e}"
    if touched:
        return True, f"residual edges {touched}"
    return True, "jitted row-streaming scan"


def _always_accepts(reason: str):
    def accepts(net: NetSpec, a: int, b: int,
                ctx: registry.RouteContext) -> tuple[bool, str]:
        if _oversized(net, a, b, ctx):
            return True, "oversized single layer (lower bound)"
        return True, reason
    return accepts


# --------------------------------------------------------------------------
# Built-in engines: span runners
# --------------------------------------------------------------------------

def _run_kernel(params, net: NetSpec, a: int, b: int, stored, spill, *,
                out_rows: int = 1):
    """The fused kernel on one span: residual sources crossing in ride as
    device-memory operands, partition-crossing interior sources spill as
    extra kernel outputs, ``out_rows`` output row-planes per step."""
    src_keys = span_ops.crossing_source_keys(net, a, b)
    out = span_ops.span_forward(stored[a], params[a:b], net, a, b,
                                out_rows=out_rows,
                                srcs={s: stored[s] for s in src_keys},
                                spill=spill)
    if spill:
        return out  # already (ys, {map -> spilled})
    return out, {}


def _run_scan(params, net: NetSpec, a: int, b: int, stored, spill, *,
              out_rows: int = 1):
    """Row-streaming of one span over its static schedule, batched."""
    src_keys = span_ops.crossing_source_keys(net, a, b)
    schedule = closure.span_schedule(net, a, b, spill=spill,
                                     out_rows=out_rows)
    out, spills = cnn.span_scan(
        stored[a], params[a:b], tuple(stored[s] for s in src_keys),
        net=net, a=a, b=b, schedule=schedule, spill=spill,
        src_keys=src_keys)
    return out, dict(zip(spill, spills))


def _run_oracle(params, net: NetSpec, a: int, b: int, stored, spill, *,
                out_rows: int = 1):
    """Layer-by-layer batched execution of one span (+ residual adds)."""
    maps = {a: stored[a]}
    y = stored[a]
    for m in range(a + 1, b + 1):
        y = cnn.layer_forward(params, net, m - 1, y)
        for (s, t) in net.residual_edges:
            if t != m:
                continue
            src = stored[s] if s < a else maps[s]
            y = y + cnn._project_shortcut(src, *y.shape[1:])
        maps[m] = y
    return y, {m: maps[m] for m in spill}


def _run_interpreted(params, net: NetSpec, a: int, b: int, stored, spill, *,
                     out_rows: int = 1):
    """The RowRing loop (executable specification), per image.

    ``out_rows`` is accepted for signature parity and ignored: the
    specification produces single rows, so tile height changes nothing
    about its results."""
    outs, spills = [], {m: [] for m in spill}
    for i in range(stored[a].shape[0]):
        sto_i = {k: v[i] for k, v in stored.items()}
        out, sp = cnn._stream_span(params, net, a, b, sto_i, set(spill))
        outs.append(out)
        for m in spill:
            spills[m].append(sp[m])
    return torch.stack(outs), {m: torch.stack(v) for m, v in spills.items()}


# --------------------------------------------------------------------------
# Pipeline stage bodies (the STAP runtime's span cores)
# --------------------------------------------------------------------------

def _kernel_spmd_body(net: NetSpec, a: int, b: int, spill, src_keys, *,
                      out_rows: int = 1):
    """Stage-body builder for the kernel engine: the fused span as a
    pipeline stage core, ``body(span_params, x, srcs) -> (out, spilled)``.
    Exactly as :func:`_run_kernel`: a CUDA batch launches the kernel, a CPU
    batch runs its plain version, and no other device has a route."""
    def body(span_params, x, srcs):
        out = span_ops.span_forward(x, list(span_params), net, a, b,
                                    out_rows=out_rows,
                                    srcs=dict(zip(src_keys, srcs)),
                                    spill=spill)
        return out if spill else (out, {})

    return body


def _scan_spmd_body(net: NetSpec, a: int, b: int, spill, src_keys, *,
                    out_rows: int = 1):
    """Stage-body builder for the scan engine: the same row-streaming math
    as :func:`_run_scan`, with the static span schedule built once at
    pipeline build time."""
    schedule = closure.span_schedule(net, a, b, spill=spill,
                                     out_rows=out_rows)

    def body(span_params, x, srcs):
        out, spills = cnn.span_scan(x, list(span_params), tuple(srcs),
                                    net=net, a=a, b=b, schedule=schedule,
                                    spill=spill, src_keys=src_keys)
        return out, dict(zip(spill, spills))

    return body


def _oracle_spmd_body(net: NetSpec, a: int, b: int, spill, src_keys, *,
                      out_rows: int = 1):
    """Stage-body builder for the oracle engine (lower-bound spans)."""
    def body(span_params, x, srcs):
        stored = {a: x, **dict(zip(src_keys, srcs))}
        full = [{}] * a + list(span_params)
        return _run_oracle(full, net, a, b, stored, spill)

    return body


# Auto-dispatch order: kernel > scan > oracle. The interpreted
# specification never wins auto (the oracle accepts everything first) but
# is a valid forced backend. spmd_capable marks the engines with a
# pipeline stage body: kernel/scan/oracle all register a make_spmd_body
# (the kernel's body launches the CUDA kernel on a CUDA stage, so
# kernel-routed spans drive pipeline stages directly, no scan
# substitution); only the interpreted per-image loop stays off pipelines.
registry.register_engine(
    ROUTE_KERNEL, priority=10, accepts=_kernel_accepts, run=_run_kernel,
    spmd_capable=True, make_spmd_body=_kernel_spmd_body,
    dtypes=_KERNEL_DTYPES,
    description="hand-written CUDA fused-span kernel (plain PyTorch "
                "version on CPU tensors)")
registry.register_engine(
    ROUTE_SCAN, priority=20, accepts=_scan_accepts, run=_run_scan,
    spmd_capable=True, make_spmd_body=_scan_spmd_body,
    dtypes=_KERNEL_DTYPES,
    description="row-streaming loop over the span schedule "
                "(residual-capable)")
registry.register_engine(
    ROUTE_ORACLE, priority=30, accepts=_always_accepts(
        "layer-by-layer fallback"), run=_run_oracle,
    spmd_capable=True, make_spmd_body=_oracle_spmd_body,
    description="layer-by-layer oracle (lower-bound spans)")
registry.register_engine(
    ROUTE_INTERPRETED, priority=100, accepts=_always_accepts(
        "interpreted RowRing specification"), run=_run_interpreted,
    description="per-row RowRing loop (executable specification)")

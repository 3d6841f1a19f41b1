"""Public ops: Occam fused-span execution with validation and routing.

``span_forward`` runs any conv/pool span of a NetSpec (per-layer k,
stride >= 1, same-padding, batch > 1, residual edges, multi-row output
tiles). Where the batch lies decides the route, and nothing else does: a
CUDA tensor launches the hand-written kernel (``kernel.py``), a CPU
tensor runs its plain PyTorch version (``ref.span_plain``). There is no
fallback from one to the other. ``fused_span`` keeps the legacy two-conv
signature by building the equivalent 2-layer NetSpec.

Residual edges crossing *into* the span need their device-memory source
maps in ``srcs``; interior sources of partition-crossing edges are
materialized by listing them in ``spill``. ``repro_torch.runtime
.span_engine`` wires both per DP partition.
"""
from __future__ import annotations

import torch

from repro_torch.core import closure
from repro_torch.core.graph import NetSpec, chain

from .kernel import (crossing_source_keys, crossing_sources, span_cuda_call,
                     span_kernel_scratch_elems)
from .ref import fused_span_ref, span_plain


def span_plain_call(xs: torch.Tensor, layer_params: list[dict],
                    net: NetSpec, a: int, b: int, *, out_rows: int = 1,
                    srcs: dict[int, torch.Tensor] | None = None,
                    spill: tuple[int, ...] = ()):
    """The plain version under the kernel's calling convention:
    ``(L_b maps, {spilled map -> array})``."""
    spill = tuple(sorted(set(spill)))
    schedule = closure.span_schedule(net, a, b, spill=spill,
                                     out_rows=out_rows)
    src_keys = crossing_sources(net, a, b, srcs)
    out, spills = span_plain(xs, layer_params[:b - a],
                             tuple(srcs[s] for s in src_keys), net=net,
                             a=a, b=b, schedule=schedule, spill=spill,
                             src_keys=src_keys)
    return out, dict(zip(spill, spills))


def span_forward(xs: torch.Tensor, layer_params: list[dict], net: NetSpec,
                 a: int, b: int, out_rows: int = 1,
                 srcs: dict[int, torch.Tensor] | None = None,
                 spill: tuple[int, ...] = ()):
    """Execute SPAN(a, b) of ``net``: one kernel launch on a CUDA batch,
    the plain version on a CPU batch.

    xs: (B, H, W, C) batch (or (H, W, C), auto-promoted) of L_a planes.
    ``out_rows``: output row-planes per step (tile height t, Eqn. 6).
    ``srcs``: sources of residual edges crossing into the span
    ({map index -> (B, h, w, c) or (h, w, c) matching xs}).
    ``spill``: interior maps to materialize for downstream spans.

    Returns feature map L_b, or ``(L_b, {map -> array})`` when ``spill``
    is non-empty.
    """
    if not (0 <= a < b <= net.n_layers):
        raise ValueError(f"bad span ({a}, {b})")
    squeeze = xs.ndim == 3
    if squeeze:
        xs = xs[None]
        srcs = {s: v[None] for s, v in (srcs or {}).items()}
    if tuple(xs.shape[1:]) != net.map_shape(a):
        raise ValueError(f"input {tuple(xs.shape[1:])} != map L_{a} "
                         f"{net.map_shape(a)}")
    if len(layer_params) != b - a:
        raise ValueError("layer_params must align with net.layers[a:b]")
    for off, layer in enumerate(net.layers[a:b]):
        if layer.kind == "conv":
            w = layer_params[off]["w"]
            if tuple(w.shape) != (layer.k, layer.k, layer.in_ch,
                                  layer.out_ch):
                raise ValueError(f"layer {a + off} weight shape "
                                 f"{tuple(w.shape)}")
    if xs.device.type == "cuda":
        call = span_cuda_call
    elif xs.device.type == "cpu":
        call = span_plain_call
    else:
        raise ValueError(f"no fused-span route for device {xs.device}")
    ys, spilled = call(xs, layer_params, net, a, b, out_rows=out_rows,
                       srcs=srcs, spill=spill)
    if squeeze:
        ys = ys[0]
        spilled = {m: v[0] for m, v in spilled.items()}
    return (ys, spilled) if spill else ys


def fused_span(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Two stacked same-padded stride-1 conv+ReLU layers, fused so the
    intermediate map stays in the span's ring.

    x: (H, W, Cin); w1: (k, k, Cin, Cmid); w2: (k, k, Cmid, Cout).
    """
    k = w1.shape[0]
    if w1.shape[0] != w1.shape[1] or w2.shape[0] != w2.shape[1]:
        raise ValueError("square filters only")
    if w2.shape[0] != k:
        raise ValueError("both layers must share k")
    if k % 2 != 1:
        raise ValueError("odd k only (same padding)")
    if x.ndim != 3 or x.shape[-1] != w1.shape[2] or w1.shape[3] != w2.shape[2]:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} "
                         f"{tuple(w1.shape)} {tuple(w2.shape)}")
    h, w, _ = x.shape
    net = chain("fused_span", [("conv", k, 1, k // 2, int(w1.shape[3])),
                               ("conv", k, 1, k // 2, int(w2.shape[3]))],
                in_h=h, in_w=w, in_ch=int(x.shape[-1]))
    return span_forward(x, [{"w": w1, "b": b1}, {"w": w2, "b": b2}],
                        net, 0, 2)


__all__ = ["crossing_source_keys", "fused_span", "fused_span_ref",
           "span_forward", "span_kernel_scratch_elems", "span_plain_call"]

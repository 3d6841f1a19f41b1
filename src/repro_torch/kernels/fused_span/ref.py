"""Plain PyTorch version of the fused-span kernel, and the two-conv oracle.

:func:`span_plain` is the row-streaming loop over a
:class:`~repro_torch.core.closure.SpanSchedule` built from the ``rowops``
twins, with the batch dimension written out. It computes exactly what the
CUDA kernel computes: one closure-sized ring per map ``a .. b-1``, the
step's input block arriving into ring 0, scheduled rows produced in map
order, residual adds from a ring or a device-memory ``srcs`` operand,
spilled interior maps and the output map written row by row. The
``scan`` engine runs this same function, so the kernel, the scan twin
and the CPU path share one definition of the arithmetic.

:func:`fused_span_ref` is the layer-by-layer oracle for the legacy
two-conv ``fused_span`` signature.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.closure import SpanSchedule
from repro_torch.core.graph import NetSpec

from .rowops import NEG_INF, conv_row, pool_row, project_row, ring_window


def span_plain(xs: torch.Tensor, span_params, srcs: tuple, *, net: NetSpec,
               a: int, b: int, schedule: SpanSchedule,
               spill: tuple[int, ...], src_keys: tuple[int, ...]):
    """SPAN(a, b) on a batch ``xs`` (B, H, W, C) by the static schedule.

    ``span_params`` aligns with ``net.layers[a:b]``; ``srcs`` holds the
    (B, h, w, c) maps of ``src_keys`` (residual sources crossing into the
    span). Returns ``(L_b batch, tuple of spilled maps in spill order)``.
    """
    n_maps = b - a + 1
    caps, h = schedule.ring_caps, schedule.heights
    batch, dtype, dev = xs.shape[0], xs.dtype, xs.device
    rings = [torch.zeros((batch, caps[off]) + net.map_shape(a + off)[1:],
                         dtype=dtype, device=dev)
             for off in range(n_maps - 1)]
    out = torch.zeros((batch,) + net.map_shape(b), dtype=dtype, device=dev)
    spills = [torch.zeros((batch,) + net.map_shape(m), dtype=dtype,
                          device=dev) for m in spill]
    table = schedule.slot_table()
    for t in range(schedule.n_steps):
        blk = schedule.arrivals[t]
        if blk >= 0:
            for ii in range(schedule.in_rows):
                g = blk * schedule.in_rows + ii
                if g < h[0]:
                    rings[0][:, g % caps[0]] = xs[:, g]
        slot = 0
        for off in range(1, n_maps):
            m = a + off
            layer = net.layers[m - 1]
            w_m, c_m = net.map_shape(m)[1], net.map_shape(m)[2]
            for _ in range(schedule.slots[off - 1]):
                r = table[t][slot]
                slot += 1
                if r < 0:
                    continue
                pad_val = 0.0 if layer.kind == "conv" else NEG_INF
                win = ring_window(rings[off - 1], r, layer.k, layer.stride,
                                  layer.padding, h[off - 1], caps[off - 1],
                                  pad_val)
                if layer.kind == "conv":
                    p = span_params[off - 1]
                    row = conv_row(win, p["w"], p["b"], layer.stride,
                                   layer.padding, layer.out_w)
                else:
                    row = pool_row(win, layer.k, layer.stride,
                                   layer.padding, layer.out_w)
                for (s, tt) in net.residual_edges:
                    if tt != m:
                        continue
                    h_s = net.map_shape(s)[0]
                    src_abs = min(r * max(h_s // h[off], 1), h_s - 1)
                    if s < a:
                        src_row = srcs[src_keys.index(s)][:, src_abs]
                    else:
                        src_row = rings[s - a][:, src_abs % caps[s - a]]
                    row = row + project_row(src_row.to(torch.float32),
                                            w_m, c_m)
                row = row.to(dtype)
                if off < n_maps - 1:
                    rings[off][:, r % caps[off]] = row
                else:
                    out[:, r] = row
                if m in spill:
                    spills[spill.index(m)][:, r] = row
    return out, tuple(spills)


def conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (H, W, Cin), w: (k, k, Cin, Cout), same padding, stride 1."""
    k = w.shape[0]
    y = F.conv2d(x.to(torch.float32).permute(2, 0, 1)[None],
                 w.to(torch.float32).permute(3, 2, 0, 1), padding=k // 2)[0]
    y = y.permute(1, 2, 0)
    return torch.relu(y + b.to(torch.float32)).to(x.dtype)


def fused_span_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    return conv_relu(conv_relu(x, w1, b1), w2, b2)

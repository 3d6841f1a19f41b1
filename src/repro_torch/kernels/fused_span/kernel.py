"""Wrapper of the Hopper fused-span kernel (``csrc/fused_span.cu``).

The TPU kernel (``repro/kernels/fused_span/kernel.py``) is generated and
unrolled per span. Compiling per span with nvcc would cost seconds each,
so the CUDA kernel is compiled once and reads a per-span *descriptor*:
map geometry, ring caps and ring offsets into the workspace, the residual
table, the spill list, and the schedule's slot table and arrivals, all
int32. The descriptor is built from ``closure.span_schedule`` and sent to
the device once per (schedule, device), then cached. The pointers of one
call (input, output, workspace, weights, biases, residual sources,
spills) travel by value as kernel parameters, so new params or inputs
never rebuild a descriptor.

The rings live in a device-memory workspace of exactly
``batch x schedule.scratch_elems()`` elements, allocated here with
``torch.empty``; the kernel launches on the current stream, does not
synchronise, and ``launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import closure
from repro_torch.core.graph import NetSpec

from .. import _build

# kernel launches since import (or since the caller last reset it)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pointer-table sizes of the kernel's by-value SpanPtrs
MAX_CONV, MAX_SRC, MAX_SPILL = 128, 8, 8

# field counts of the descriptor records (csrc/fused_span.cu enums)
_H_LEN, _M_LEN, _R_LEN = 10, 13, 5

_descriptors: dict = {}


def _descriptor(net: NetSpec, a: int, b: int,
                schedule: closure.SpanSchedule, spill: tuple[int, ...],
                src_keys: tuple[int, ...]) -> list[int]:
    """The int32 descriptor the kernel reads for SPAN(a, b)."""
    n_maps = b - a + 1
    maps: list[int] = []
    res: list[int] = []
    ring_off = 0
    n_conv = 0
    for off in range(n_maps):
        m = a + off
        h, w, c = net.map_shape(m)
        kind = k = stride = pad = 0
        conv = -1
        edges = []
        if off > 0:
            layer = net.layers[m - 1]
            kind = 0 if layer.kind == "conv" else 1
            k, stride, pad = layer.k, layer.stride, layer.padding
            if layer.kind == "conv":
                conv, n_conv = n_conv, n_conv + 1
            edges = [s for (s, t) in net.residual_edges if t == m]
        cap = schedule.ring_caps[off] if off < n_maps - 1 else 0
        res0 = len(res) // _R_LEN
        for s in edges:
            src = [1, src_keys.index(s)] if s < a else [0, s - a]
            res += src + list(net.map_shape(s))
        maps += [kind, k, stride, pad, h, w, c, cap, ring_off, res0,
                 len(edges), spill.index(m) if m in spill else -1, conv]
        ring_off += cap * w * c
    if ring_off != schedule.scratch_elems():
        raise AssertionError("ring offsets disagree with the schedule's "
                             "scratch size")
    table = [r for row in schedule.slot_table() for r in row]
    body = [maps, res, list(schedule.slots), list(schedule.arrivals), table]
    offsets, pos = [], _H_LEN
    for part in body:
        offsets.append(pos)
        pos += len(part)
    header = [n_maps, schedule.in_rows, schedule.n_steps,
              schedule.total_slots, len(res) // _R_LEN] + offsets
    return header + [v for part in body for v in part]


def _device_descriptor(net, a, b, schedule, spill, src_keys,
                       device: torch.device) -> torch.Tensor:
    key = (net, a, b, schedule, spill, src_keys, device)
    desc = _descriptors.get(key)
    if desc is None:
        desc = torch.tensor(_descriptor(net, a, b, schedule, spill, src_keys),
                            dtype=torch.int32, device=device)
        _descriptors[key] = desc
    return desc


def crossing_source_keys(net: NetSpec, a: int, b: int) -> tuple[int, ...]:
    """The residual sources crossing into SPAN(a, b) from device memory,
    in operand order."""
    return tuple(sorted({s for (s, t) in net.residual_edges
                         if s < a < t <= b}))


def crossing_sources(net: NetSpec, a: int, b: int,
                     srcs: dict | None) -> tuple[int, ...]:
    """:func:`crossing_source_keys`, raising ValueError when ``srcs`` lacks
    one of them."""
    src_keys = crossing_source_keys(net, a, b)
    missing = [s for s in src_keys if s not in (srcs or {})]
    if missing:
        raise ValueError(
            f"span ({a}, {b}) needs device-memory residual sources "
            f"{missing}; pass them via srcs=")
    return src_keys


def _launcher():
    fn = _build.library("fused_span").occam_fused_span_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, ctypes.c_longlong, p, p, i, p, i, p, i,
                       i, p]
        fn.restype = i
    return fn


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


def span_cuda_call(xs: torch.Tensor, layer_params: list[dict], net: NetSpec,
                   a: int, b: int, *, out_rows: int = 1,
                   srcs: dict[int, torch.Tensor] | None = None,
                   spill: tuple[int, ...] = ()
                   ) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
    """Run SPAN(a, b) of ``net`` on a CUDA batch ``xs`` (B, H, W, C) under
    one launch of the fused-span kernel.

    ``layer_params`` aligns with ``net.layers[a:b]`` ({"w", "b"} per conv,
    {} per pool); ``srcs`` maps each residual source crossing into the
    span to its (B, h, w, c) map; ``spill`` lists interior maps to write
    out. Returns ``(L_b maps, {spilled map -> array})``. Raises on a CPU
    tensor, an unsupported dtype, or a failed build or launch.
    """
    global launches
    spill = tuple(sorted(set(spill)))
    schedule = closure.span_schedule(net, a, b, spill=spill,
                                     out_rows=out_rows)
    src_keys = crossing_sources(net, a, b, srcs)
    if not xs.is_cuda:
        raise ValueError("span_cuda_call takes CUDA tensors; "
                         f"got one on {xs.device}")
    if xs.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused-span kernel takes {list(_DTYPE_CODES)}, "
                         f"got {xs.dtype}")
    dev = xs.device
    xs = xs.contiguous()
    src_list = []
    for s in src_keys:
        t = srcs[s]
        if t.device != dev or t.dtype != xs.dtype or \
                tuple(t.shape) != (xs.shape[0],) + net.map_shape(s):
            raise ValueError(f"residual source {s} must be a "
                             f"{(xs.shape[0],) + net.map_shape(s)} "
                             f"{xs.dtype} tensor on {dev}")
        src_list.append(t.contiguous())
    w_list, b_list = [], []
    for off, layer in enumerate(net.layers[a:b]):
        if layer.kind == "conv":
            p = layer_params[off]
            w_list.append(p["w"].to(dev, torch.float32).contiguous())
            b_list.append(p["b"].to(dev, torch.float32).contiguous())
    if len(w_list) > MAX_CONV or len(src_list) > MAX_SRC \
            or len(spill) > MAX_SPILL:
        raise ValueError(
            f"span ({a}, {b}) has {len(w_list)} convs, {len(src_list)} "
            f"crossing sources and {len(spill)} spills; the kernel takes "
            f"at most {MAX_CONV}, {MAX_SRC} and {MAX_SPILL}")
    batch = xs.shape[0]
    out = torch.empty((batch,) + net.map_shape(b), dtype=xs.dtype,
                      device=dev)
    spills = [torch.empty((batch,) + net.map_shape(m), dtype=xs.dtype,
                          device=dev) for m in spill]
    per_image = schedule.scratch_elems()
    workspace = torch.empty(batch * per_image, dtype=xs.dtype, device=dev)
    desc = _device_descriptor(net, a, b, schedule, spill, src_keys, dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(_DTYPE_CODES[xs.dtype], desc.data_ptr(), xs.data_ptr(),
                    out.data_ptr(), workspace.data_ptr(), per_image,
                    _ptr_array(w_list), _ptr_array(b_list), len(w_list),
                    _ptr_array(src_list), len(src_list),
                    _ptr_array(spills), len(spills), batch, stream)
    if rc != 0:
        raise RuntimeError(f"fused-span kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, dict(zip(spill, spills))


def span_kernel_scratch_elems(net: NetSpec, a: int, b: int,
                              out_rows: int = 1) -> tuple[int, int]:
    """(ring workspace elems per image, weight elems) of the CUDA kernel.

    The workspace is exactly |DC(a, b)| at the given tile height, and the
    sum equals ``span_footprint_elems``: the twin of the reference's
    ``span_kernel_vmem_elems``."""
    schedule = closure.span_schedule(net, a, b, out_rows=out_rows)
    return schedule.scratch_elems(), net.span_weight_elems(a, b)

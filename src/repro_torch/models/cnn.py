"""PyTorch execution of NetSpecs: the layer-by-layer oracle and Occam's
row-streaming execution with closure-sized circular buffers (paper §III-C).

Layouts are the reference's: NHWC activations, HWIO ``(k, k, Cin, Cout)``
weights, params as a list of ``{"w", "b"}`` dicts (``{}`` for pools)
indexed by layer. Functions take a batch ``(B, H, W, C)``; the batch
dimension is written out where the reference mapped over images.

* ``reference_forward`` — the oracle: each layer as one
  ``torch.nn.functional`` convolution or max-pool over the whole map.
* ``span_scan`` — the scan engine's span body: the span's static schedule
  (``closure.span_schedule``) run by the plain fused-span loop
  (``repro_torch.kernels.fused_span.ref.span_plain``), the same loop that
  is the CUDA kernel's plain version.
* ``_stream_span`` + ``RowRing`` — the interpreted per-row loop, kept as
  the executable specification: its reads check the retention invariant.
* ``occam_forward`` — the whole net span by span through either of the
  two (``mode="compiled"``: the scan engine; ``"interpreted"``: the
  RowRing loop), with transfers counted; ``occam_forward_jit`` is the
  same call (eager PyTorch has nothing to jit).

Off-chip transfers are counted per span boundary (``count_span_reads`` /
``count_span_writes``), identically for every engine, and checked against
the DP's predicted ``OP[0,n].X`` (model == machine).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import closure, traffic
from repro_torch.core.graph import LayerSpec, NetSpec
from repro_torch.kernels.fused_span import ref, rowops

NEG_INF = rowops.NEG_INF


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, net: NetSpec, scale: float = 0.1,
                dtype=torch.float32, device=None) -> list[dict]:
    """Random params: N(0, 1) x ``scale`` weights and biases per conv."""
    params: list[dict] = []
    for layer in net.layers:
        if layer.kind == "conv":
            w = torch.randn((layer.k, layer.k, layer.in_ch, layer.out_ch),
                            generator=generator, dtype=dtype) * scale
            b = torch.randn((layer.out_ch,), generator=generator,
                            dtype=dtype) * scale
            params.append({"w": w.to(device), "b": b.to(device)})
        else:
            params.append({})
    return params


# --------------------------------------------------------------------------
# Primitive ops (oracle and interpreted streaming)
# --------------------------------------------------------------------------

def _conv_window(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 layer: LayerSpec) -> torch.Tensor:
    """Conv over a (B, R, W, Cin) row window that already includes the
    exact vertical halo (VALID in H); horizontal padding applied here."""
    y = F.conv2d(window.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=layer.stride, padding=(0, layer.padding))
    return torch.relu(y.permute(0, 2, 3, 1) + b)


def _pool_window(window: torch.Tensor, layer: LayerSpec) -> torch.Tensor:
    """Max-pool over a (B, R, W, C) row window with exact vertical halo,
    already ``NEG_INF``-padded for out-of-range rows; pads horizontally
    with ``NEG_INF`` here."""
    if layer.padding:
        window = F.pad(window, (0, 0, layer.padding, layer.padding),
                       value=NEG_INF)
    y = F.max_pool2d(window.permute(0, 3, 1, 2), layer.k, layer.stride)
    return y.permute(0, 2, 3, 1)


def _project_shortcut(src: torch.Tensor, h_t: int, w_t: int,
                      c_t: int) -> torch.Tensor:
    """Parameter-free 'option A' shortcut of a (B, h, w, c) map: strided
    subsample + channel zero-pad or trim."""
    h_s, w_s, c_s = src.shape[1:]
    sh, sw = max(h_s // h_t, 1), max(w_s // w_t, 1)
    y = src[:, ::sh, ::sw, :][:, :h_t, :w_t, :]
    if c_t > c_s:
        y = F.pad(y, (0, c_t - c_s))
    elif c_t < c_s:
        y = y[..., :c_t]
    return y


def _pad_rows_zero(x: torch.Tensor, layer: LayerSpec) -> torch.Tensor:
    p = layer.padding
    return F.pad(x, (0, 0, 0, 0, p, p)) if p else x


def _pad_rows_neg(x: torch.Tensor, layer: LayerSpec) -> torch.Tensor:
    p = layer.padding
    return F.pad(x, (0, 0, 0, 0, p, p), value=NEG_INF) if p else x


def layer_forward(params: list[dict], net: NetSpec, idx: int,
                  x: torch.Tensor) -> torch.Tensor:
    """Layer ``idx`` of ``net`` on a whole (B, H, W, C) map, residual adds
    excluded."""
    layer = net.layers[idx]
    if layer.kind == "conv":
        return _conv_window(_pad_rows_zero(x, layer), params[idx]["w"],
                            params[idx]["b"], layer)
    return _pool_window(_pad_rows_neg(x, layer), layer)


# --------------------------------------------------------------------------
# Oracle: layer-by-layer forward (the paper's base case, functionally)
# --------------------------------------------------------------------------

def reference_forward(params: list[dict], xs: torch.Tensor, net: NetSpec,
                      collect: bool = False):
    """xs: (B, H, W, C) batch or one (H, W, C) image. Returns the final map
    (or, with ``collect``, every map L_0 .. L_n)."""
    squeeze = xs.ndim == 3
    maps = [xs[None] if squeeze else xs]
    for idx in range(net.n_layers):
        y = layer_forward(params, net, idx, maps[-1])
        for (s, t) in net.residual_edges:
            if t == idx + 1:
                y = y + _project_shortcut(maps[s], *y.shape[1:])
        maps.append(y)
    if squeeze:
        maps = [m[0] for m in maps]
    return maps if collect else maps[-1]


# --------------------------------------------------------------------------
# Occam streaming execution
# --------------------------------------------------------------------------

class RowRing:
    """Circular buffer of the most recent ``capacity`` row-planes of a map.

    Reads assert the retention invariant: a requested row must still be
    resident — i.e. the closure arithmetic that sized this ring must have
    been sufficient. This is the executable sufficient condition.
    """

    def __init__(self, capacity: int, w: int, c: int, dtype, device=None):
        self.capacity = capacity
        self.buf = torch.zeros((capacity, w, c), dtype=dtype, device=device)
        self.next = 0  # absolute index of the next row to be written

    def push(self, rows: torch.Tensor) -> None:
        for r in range(rows.shape[0]):
            self.buf[(self.next + r) % self.capacity] = rows[r]
        self.next += rows.shape[0]

    def window(self, a: int, b: int, h: int, pad_value: float) -> torch.Tensor:
        """Rows [a, b) in absolute coordinates; rows outside [0, h) padded."""
        out = []
        pad = torch.full(self.buf.shape[1:], pad_value, dtype=self.buf.dtype,
                         device=self.buf.device)
        for r in range(a, b):
            if r < 0 or r >= h:
                out.append(pad)
                continue
            if r < self.next - self.capacity or r >= self.next:
                raise AssertionError(
                    f"ring violation: row {r} not resident "
                    f"(have [{self.next - self.capacity}, {self.next}))")
            out.append(self.buf[r % self.capacity])
        return torch.stack(out)


TrafficCounter = traffic.TrafficCounter


def count_span_reads(counter: TrafficCounter | None, net: NetSpec, a: int,
                     b: int, batch: int = 1,
                     bytes_per_elem: float = 4.0) -> None:
    """Off-chip reads to start SPAN(a, b): the span input streamed in once,
    plus residual sources read from device memory by edges crossing INTO
    the span. Shared by every engine so model==machine holds regardless of
    dispatch."""
    if counter is None:
        return
    counter.add_reads(batch * net.map_elems(a), bytes_per_elem)
    for (s, t) in net.residual_edges:
        if s < a < t <= b:
            counter.add_reads(batch * net.map_elems(s), bytes_per_elem)


def count_span_writes(counter: TrafficCounter | None, net: NetSpec, b: int,
                      spilled, batch: int = 1,
                      bytes_per_elem: float = 4.0) -> None:
    """Off-chip writes to finish a span: its output map plus any spilled
    interior residual sources."""
    if counter is None:
        return
    counter.add_writes(batch * net.map_elems(b), bytes_per_elem)
    for m in spilled:
        counter.add_writes(batch * net.map_elems(m), bytes_per_elem)


# The scan engine's span body: SPAN(a, b) on a batch by its static
# schedule, which is the fused-span kernel's plain version.
span_scan = ref.span_plain


def occam_forward(params: list[dict], x: torch.Tensor, net: NetSpec,
                  boundaries: list[int] | None = None,
                  counter: TrafficCounter | None = None,
                  mode: str = "compiled") -> torch.Tensor:
    """Execute the net span-by-span with closure-sized ring buffers.

    ``x``: a (B, H, W, C) batch or one (H, W, C) image (the reference's
    signature). ``boundaries``: interior partition points (from the DP).
    ``counter`` accumulates off-chip element transfers for
    model-vs-machine validation, per image of the batch. ``mode``:
    "compiled" (the scan engine: :data:`span_scan` over each span's
    static schedule) or "interpreted" (the Python RowRing loop — the
    executable specification).
    """
    from repro_torch.occam import registry
    from repro_torch.runtime import span_engine

    if mode not in ("compiled", "interpreted"):
        raise ValueError(f"bad mode {mode!r}")
    engine = registry.get_engine(span_engine.ROUTE_SCAN if mode == "compiled"
                                 else span_engine.ROUTE_INTERPRETED)
    squeeze = x.ndim == 3
    xs = x[None] if squeeze else x
    batch = xs.shape[0]
    boundaries = list(boundaries or [])
    cuts = [0] + boundaries + [net.n_layers]
    stored: dict[int, torch.Tensor] = {0: xs}
    for a, b in zip(cuts, cuts[1:]):
        # residual edges that cross a partition boundary spill their source
        spill = span_engine.span_spills(net, boundaries, a, b)
        count_span_reads(counter, net, a, b, batch)
        out, spilled = engine.run(params, net, a, b, stored, spill)
        count_span_writes(counter, net, b, spilled, batch)
        stored[b] = out
        stored.update(spilled)
    y = stored[net.n_layers]
    return y[0] if squeeze else y


def occam_forward_jit(params, x: torch.Tensor, net: NetSpec,
                      boundaries: tuple[int, ...] = ()) -> torch.Tensor:
    """Whole-net Occam execution through the scan engine, the twin of the
    reference's single-jit call: the same as :func:`occam_forward` in
    ``"compiled"`` mode without a counter, since eager PyTorch has
    nothing to jit. ``boundaries`` is a tuple, as the reference's static
    argument."""
    return occam_forward(params, x, net, list(boundaries), None, "compiled")


def params_w(span_params, off: int) -> torch.Tensor:
    """The weights of map ``a + off``'s layer among a span's params."""
    return span_params[off - 1]["w"]


def params_b(span_params, off: int) -> torch.Tensor:
    """The bias of map ``a + off``'s layer among a span's params."""
    return span_params[off - 1]["b"]


def _stream_span(params: list[dict], net: NetSpec, a: int, b: int,
                 stored: dict[int, torch.Tensor], spill_sources: set[int]):
    """Produce map ``b`` of one image from stored map ``a`` (H, W, C), one
    output row at a time, through RowRings sized by the closure."""
    x_in = stored[a]
    dtype, dev = x_in.dtype, x_in.device
    row_counts = closure.span_row_counts(net, a, b)  # maps a .. b-1
    rings: dict[int, RowRing] = {}
    for off, rows in enumerate(row_counts):
        m = a + off
        _h, w, c = net.map_shape(m)
        rings[m] = RowRing(rows, w, c, dtype, dev)
    produced = {m: 0 for m in range(a, b + 1)}
    h_out = net.map_shape(b)[0]
    out_rows: list[torch.Tensor] = []
    spill_targets = {m for m in spill_sources if a < m < b}
    spilled: dict[int, list[torch.Tensor]] = {m: [] for m in spill_targets}

    def ensure(m: int, upto: int) -> None:
        """Guarantee map m has rows [0, upto) produced (and ring-resident)."""
        upto = min(upto, net.map_shape(m)[0])
        if produced[m] >= upto:
            return
        if m == a:
            rings[m].push(x_in[produced[m]:upto])
            produced[m] = upto
            return
        layer = net.layers[m - 1]
        lo = produced[m] * layer.stride - layer.padding
        hi = (upto - 1) * layer.stride - layer.padding + layer.k
        h_in = net.map_shape(m - 1)[0]
        ensure(m - 1, min(hi, h_in))
        pad_val = 0.0 if layer.kind == "conv" else NEG_INF
        window = rings[m - 1].window(lo, hi, h_in, pad_val)[None]
        if layer.kind == "conv":
            new = _conv_window(window, params[m - 1]["w"], params[m - 1]["b"],
                               layer)[0]
        else:
            new = _pool_window(window, layer)[0]
        for (s, t) in net.residual_edges:
            if t != m:
                continue
            h_s = net.map_shape(s)[0]
            sh = max(h_s // net.map_shape(m)[0], 1)
            src_abs = [min(r * sh, h_s - 1) for r in range(produced[m], upto)]
            if s < a:  # crossed into the span: the source is in memory
                src_rows = torch.stack([stored[s][r] for r in src_abs])
            else:
                ensure(s, max(src_abs) + 1)
                src_rows = torch.stack(
                    [rings[s].window(r, r + 1, h_s, 0.0)[0] for r in src_abs])
            w_m, c_m = net.map_shape(m)[1], net.map_shape(m)[2]
            new = new + rowops.project_row(src_rows, w_m, c_m)
        if m < b:
            rings[m].push(new)
        else:
            out_rows.append(new)
        if m in spill_targets:
            spilled[m].append(new)
        produced[m] = upto

    for r in range(h_out):
        ensure(b, r + 1)

    out = torch.cat(out_rows, dim=0)
    spilled_maps = {m: torch.cat(v, dim=0) for m, v in spilled.items()}
    return out, spilled_maps


def predicted_transfers(net: NetSpec, boundaries: list[int]) -> int:
    """The DP cost model's transfer count for a given PBS (for machine-vs-
    model equality tests), from the canonical span-local formula."""
    from repro_torch.core.partition import partition_transfers

    return int(partition_transfers(net, list(boundaries), batch=1))

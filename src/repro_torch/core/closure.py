"""Dependence-closure arithmetic (paper §III-A/B/C).

Necessary condition (C1): a tile must span one *full input row-plane*
(1 row x W x C) — anything narrower evicts elements with guaranteed future
reuse in the orthogonal dimension.

Sufficient condition / dependence closure (C2): to emit one output row-plane
of span-final map ``L_j`` while capturing *all* reuse, hold — per layer
``l in [i, j)`` — a circular buffer of ``rows_l`` input row-planes, where the
row counts follow the stride-induced arithmetic sequence (receptive-field
recurrence):

    rows(L_j) = t                      (t = output row-planes per step, >= 1)
    rows(L_l) = (rows(L_{l+1}) - 1) * stride_l + k_l     clamped to map height

The closure size |DC(i, j)| = sum_l rows(L_l) * W_l * C_l over the *input*
buffers L_i .. L_{j-1} (the final output row streams off-chip / downstream).
This matches the paper's walkthrough (Fig. 4: DC(0,1) = 3 rows x 13 x 4 = 156).

Residual edges do not grow the closure (§III-C: residual source rows are
already present as a previous layer's non-residual input).
"""
from __future__ import annotations

import dataclasses

from .graph import NetSpec


def span_row_counts(net: NetSpec, i: int, j: int, out_rows: int = 1) -> list[int]:
    """Circular-buffer heights at feature maps ``L_i .. L_{j-1}``.

    ``out_rows`` generalizes to t output row-planes per step (tile height t);
    t=1 is the paper's minimal closure.
    """
    if not (0 <= i < j <= net.n_layers):
        raise ValueError(f"bad span ({i}, {j})")
    if out_rows < 1:
        raise ValueError("out_rows must be >= 1")
    rows = out_rows
    counts_rev: list[int] = []
    for l in range(j - 1, i - 1, -1):
        layer = net.layers[l]
        rows = (rows - 1) * layer.stride + layer.k
        h_l = net.map_shape(l)[0]
        # Padding rows are synthesized, not stored; clamp to the real map.
        rows = min(rows, h_l)
        counts_rev.append(rows)
    return list(reversed(counts_rev))


def span_closure_elems(net: NetSpec, i: int, j: int, out_rows: int = 1) -> int:
    """|DC(i, j)| in elements for ``out_rows`` output row-planes per step."""
    counts = span_row_counts(net, i, j, out_rows)
    total = 0
    for off, rows in enumerate(counts):
        h, w, c = net.map_shape(i + off)
        total += rows * w * c
    return total


def span_footprint_elems(net: NetSpec, i: int, j: int, out_rows: int = 1) -> int:
    """Closure + chip-resident span filters (Eqn. 1 left-hand side)."""
    return span_closure_elems(net, i, j, out_rows) + net.span_weight_elems(i, j)


def span_footprint_bytes(net: NetSpec, i: int, j: int, out_rows: int = 1, *,
                         act_bytes: float = 4.0,
                         weight_bytes: float = 4.0) -> float:
    """Byte twin of :func:`span_footprint_elems`: the closure at the
    activation width plus resident filters at the weight width. The
    default widths are fp32, making the twin exactly ``4 x`` the elem
    count; a dtype policy (``repro.occam.quant``) supplies narrower
    widths — including a batched activation width, since closures scale
    with batch while filters stay shared (Eqn. 6)."""
    return (span_closure_elems(net, i, j, out_rows) * float(act_bytes)
            + net.span_weight_elems(i, j) * float(weight_bytes))


def max_tile_rows(net: NetSpec, i: int, j: int, capacity: int,
                  batch: int = 1) -> int:
    """Largest t (output row-planes per step) whose footprint fits capacity.

    This is the Occam ``TileDim`` reported per-partition in the paper's
    Table II (tiles are TileDim x RowWidth). Returns 0 if even t=1 misses.
    Closures scale with batch; chip-resident filters are shared (Eqn. 6).
    """
    out_h = net.map_shape(j)[0]
    weights = net.span_weight_elems(i, j)
    lo, hi, best = 1, out_h, 0
    while lo <= hi:
        mid = (lo + hi) // 2
        if batch * span_closure_elems(net, i, j, mid) + weights <= capacity:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    return best


# --------------------------------------------------------------------------
# Static row-streaming schedules (compiled span engine)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpanSchedule:
    """A fully static row-streaming schedule for SPAN(a, b).

    Grid step ``t`` consumes input row-planes ``[t*in_rows, (t+1)*in_rows)``
    (while any remain) and performs ``steps[t]`` — per produced map
    ``L_{a+1} .. L_b`` the tuple of row indices computed at that step, in
    dependency (map-ascending) order. Production is *demand-driven*: a row
    of an interior map is scheduled only in the step where a downstream row
    first needs it, so the closure-sized rings (``ring_caps``, from
    :func:`span_row_counts` at the schedule's ``out_rows``) are provably
    sufficient — the builder replays the schedule and raises
    ``AssertionError("ring violation …")`` if any read would touch an
    evicted row. That replay is the compiled-engine form of the RowRing
    retention assertion (proof-by-execution of the sufficient condition).

    The final map is throttled to ``out_rows`` rows per step, aligned to
    ``out_rows``-row groups (no step straddles a group boundary), so
    consumers can stream the output with an ``out_rows``-row block per grid
    step — the paper's Eqn.-6 tile-height amortization. ``in_rows`` is the
    matching input arrival width (``out_rows`` times the span's cumulative
    stride, clamped to the input height).

    Hashable (all-tuple fields) so it can key ``jax.jit`` static arguments.
    """

    a: int
    b: int
    ring_caps: tuple[int, ...]   # rings for maps a .. b-1
    heights: tuple[int, ...]     # map heights a .. b
    slots: tuple[int, ...]       # max rows/step for maps a+1 .. b
    steps: tuple[tuple[tuple[int, ...], ...], ...]
    out_rows: int = 1            # output rows per step (tile height t)
    in_rows: int = 1             # input rows per arrival block
    # per step: the in_rows-row input block arriving (-1 = no arrival).
    # Arrival is demand-driven — a block lands only when the next output
    # group (or a pending spill drain) needs it — so arrival can never
    # evict ring rows the chain still reads.
    arrivals: tuple[int, ...] = ()

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def total_slots(self) -> int:
        return sum(self.slots)

    def slot_table(self) -> list[list[int]]:
        """(n_steps, total_slots) row indices, -1 padded, map-major order."""
        table = []
        for ops in self.steps:
            row: list[int] = []
            for off, u in enumerate(self.slots):
                got = list(ops[off])
                row += got + [-1] * (u - len(got))
            table.append(row)
        return table

    def out_row_table(self) -> list[int]:
        """Per step: the output *block* index (``out_rows``-row groups) of
        the last output row produced so far (clamped >= 0) — the output
        BlockSpec index map for an ``out_rows``-rows-per-step stream. At
        ``out_rows=1`` this is the classic one-row-per-step row index."""
        out, last = [], 0
        for ops in self.steps:
            if ops[-1]:
                last = ops[-1][-1]
            out.append(last // self.out_rows)
        return out

    def in_row_table(self) -> list[int]:
        """Per step: the input *block* index (``in_rows``-row groups) to
        load — the last block that has arrived so far (clamped >= 0), so
        no-arrival steps revisit the previous block (no new fetch). A step
        is a fresh arrival iff its entry exceeds the previous step's."""
        tab, last = [], 0
        for blk in self.arrivals:
            if blk >= 0:
                last = blk
            tab.append(last)
        return tab

    def scratch_elems(self) -> int:
        """Ring-buffer elements the schedule requires — by construction
        exactly |DC(a, b)| (verified by tests against span_closure_elems)."""
        total = 0
        for off, cap in enumerate(self.ring_caps):
            total += cap * self._wc[off]
        return total

    # widths*chans per ring, stashed at build time (tuple -> hashable)
    _wc: tuple[int, ...] = ()


_schedule_cache: dict = {}


def span_schedule(net: NetSpec, i: int, j: int,
                  spill: frozenset[int] | tuple[int, ...] = (),
                  out_rows: int = 1) -> SpanSchedule:
    """Build + validate the demand-driven streaming schedule for SPAN(i, j).

    ``spill``: interior maps (sources of partition-crossing residual edges)
    that must be fully materialized; they are drained after the span output
    completes so early drainage can never evict rows the chain still needs.

    ``out_rows``: output rows per step (tile height t, paper Eqn. 6). Ring
    capacities come from ``span_row_counts(..., out_rows)`` and input
    arrival widens to ``out_rows`` times the span's cumulative stride.

    Raises AssertionError("ring violation …") if the ring capacities from
    ``span_row_counts`` would not retain every row the schedule reads — the
    compiled engine's executable form of the necessity/sufficiency check.

    The expensive build + replay validation is memoized; the cache key
    includes the *current* ring capacities, so a changed (or monkeypatched)
    ``span_row_counts`` always re-validates instead of hitting stale state.
    """
    caps = span_row_counts(net, i, j, out_rows)
    key = (net, i, j, tuple(sorted(set(spill))), out_rows, tuple(caps))
    cached = _schedule_cache.get(key)
    if cached is not None:
        return cached
    sched = _build_span_schedule(net, i, j, spill, caps, out_rows)
    _schedule_cache[key] = sched
    return sched


def _pick_in_rows(net: NetSpec, i: int, j: int, out_rows: int) -> int:
    """Widest input arrival block matching ``out_rows`` output rows: the
    cumulative span stride maps t output rows to t*prod(strides) input
    rows per step (clamped to the input height)."""
    stride_prod = 1
    for l in range(i, j):
        stride_prod *= net.layers[l].stride
    return min(out_rows * stride_prod, net.map_shape(i)[0])


def _build_span_schedule(net: NetSpec, i: int, j: int, spill,
                         caps: list[int], out_rows: int = 1) -> SpanSchedule:
    """Build at the widest stride-matched arrival block, halving ``in_rows``
    when replay finds the closure-sized rings cannot absorb that arrival
    granularity (a block may land only whole, so a coarse block can evict
    rows a lagging interior map still reads). ``in_rows=1`` is the paper's
    one-row-per-step stream and always retains exactly the closure."""
    in_rows = _pick_in_rows(net, i, j, out_rows)
    while True:
        try:
            return _build_span_schedule_at(net, i, j, spill, caps, out_rows,
                                           in_rows)
        except AssertionError:
            if in_rows <= 1:
                raise
            in_rows = max(in_rows // 2, 1)


def _build_span_schedule_at(net: NetSpec, i: int, j: int, spill,
                            caps: list[int], out_rows: int,
                            in_rows: int) -> SpanSchedule:
    n_maps = j - i + 1
    h = [net.map_shape(i + off)[0] for off in range(n_maps)]
    if out_rows > h[-1]:
        raise ValueError(
            f"out_rows={out_rows} exceeds span output height {h[-1]}")
    in_span_spill = sorted(m for m in set(spill) if i < m < j)
    produced = [0] * n_maps
    steps: list[tuple[tuple[int, ...], ...]] = []
    arrivals: list[int] = []

    def computable(off: int, n_prev: int) -> int:
        """Rows of map i+off computable from n_prev rows of map i+off-1
        (bottom rows unlock all at once: the remaining halo is padding)."""
        lay = net.layers[i + off - 1]
        if n_prev >= h[off - 1]:
            return h[off]
        return max(0, min(h[off], (n_prev + lay.padding - lay.k)
                          // lay.stride + 1))

    def ensure(off: int, upto: int, ops: list[list[int]]) -> None:
        upto = min(upto, h[off])
        if produced[off] >= upto:
            return
        if off == 0:
            raise AssertionError(
                f"span_schedule: demand for input row {upto - 1} of map "
                f"{i} precedes its arrival")
        lay = net.layers[i + off - 1]
        hi = (upto - 1) * lay.stride - lay.padding + lay.k
        ensure(off - 1, min(hi, h[off - 1]), ops)
        for r in range(produced[off], upto):
            for (s, t) in net.residual_edges:  # in-span residual sources
                if t == i + off and s >= i:
                    sh = max(net.map_shape(s)[0] // h[off], 1)
                    ensure(s - i, min(r * sh, net.map_shape(s)[0] - 1) + 1,
                           ops)
            ops[off - 1].append(r)
        produced[off] = upto

    def input_need(off: int, upto: int) -> int:
        """Input rows of map i required to produce rows [0, upto) of map
        i+off — ensure()'s demand recursion, without mutating state."""
        upto = min(upto, h[off])
        if upto <= 0:
            return 0
        if off == 0:
            return upto
        lay = net.layers[i + off - 1]
        hi = min((upto - 1) * lay.stride - lay.padding + lay.k, h[off - 1])
        need = input_need(off - 1, hi)
        for (s, tt) in net.residual_edges:
            if tt == i + off and s >= i:
                h_s = net.map_shape(s)[0]
                sh = max(h_s // h[off], 1)
                need = max(need,
                           input_need(s - i, min((upto - 1) * sh, h_s - 1) + 1))
        return need

    limit = h[0] + sum(h) + 16
    while produced[-1] < h[-1] or any(
            produced[m - i] < h[m - i] for m in in_span_spill):
        t = len(steps)
        ops: list[list[int]] = [[] for _ in range(n_maps - 1)]
        # group-aligned output throttle: finish the current out_rows-row
        # group, never start the next in the same step (so one output
        # block per step suffices downstream)
        group_end = min((produced[-1] // out_rows + 1) * out_rows, h[-1])
        if produced[-1] < h[-1]:
            need0 = input_need(n_maps - 1, group_end)
        else:  # chain done; only pending spill drains still demand input
            need0 = max(input_need(m - i, produced[m - i] + 1)
                        for m in in_span_spill
                        if produced[m - i] < h[m - i])
        # demand-driven arrival: at most one in_rows block per step, and
        # only when the pending work actually needs more input resident
        if produced[0] < min(need0, h[0]):
            arrivals.append(produced[0] // in_rows)
            produced[0] = min(produced[0] + in_rows, h[0])
        else:
            arrivals.append(-1)
        target = produced[0]
        for off in range(1, n_maps):
            target = computable(off, target)
        ensure(n_maps - 1, min(target, group_end), ops)
        if produced[-1] >= h[-1]:
            # chain done: drain spilled maps one row/step (never earlier —
            # early drainage could evict rows the chain still needs)
            for m in in_span_spill:
                ensure(m - i, produced[m - i] + 1, ops)
        steps.append(tuple(tuple(o) for o in ops))
        if t > limit:
            raise RuntimeError(f"span_schedule({i},{j}) failed to converge")

    _validate_schedule(net, i, j, caps, h, steps, in_rows, arrivals)
    slots = tuple(max((len(s[off]) for s in steps), default=0)
                  for off in range(n_maps - 1))
    wc = tuple(net.map_shape(i + off)[1] * net.map_shape(i + off)[2]
               for off in range(n_maps - 1))
    return SpanSchedule(i, j, tuple(caps), tuple(h), slots, tuple(steps),
                        out_rows=out_rows, in_rows=in_rows,
                        arrivals=tuple(arrivals), _wc=wc)


def _validate_schedule(net: NetSpec, i: int, j: int, caps: list[int],
                       h: list[int], steps, in_rows: int = 1,
                       arrivals=None) -> None:
    """Replay the schedule in execution order; every ring read must hit a
    resident row (retention invariant) and production must be sequential."""
    n_maps = j - i + 1
    produced = [0] * n_maps
    if arrivals is None:  # legacy one-row-per-step arrival
        arrivals = [t if t < h[0] else -1 for t in range(len(steps))]
    for t, ops in enumerate(steps):
        blk = arrivals[t]
        if blk >= 0:
            if blk * in_rows != produced[0]:
                raise AssertionError(
                    f"arrival out of order: block {blk} (expected input row "
                    f"{produced[0]})")
            produced[0] = min(produced[0] + in_rows, h[0])
        for off in range(1, n_maps):
            lay = net.layers[i + off - 1]
            for r in ops[off - 1]:
                if r != produced[off]:
                    raise AssertionError(
                        f"schedule out of order: map {i + off} row {r} "
                        f"(expected {produced[off]})")
                lo = max(r * lay.stride - lay.padding, 0)
                hi = min(r * lay.stride - lay.padding + lay.k, h[off - 1])
                live = produced[off - 1] - caps[off - 1]
                if lo < live or hi > produced[off - 1]:
                    raise AssertionError(
                        f"ring violation: rows [{lo}, {hi}) of map "
                        f"{i + off - 1} not resident "
                        f"(have [{live}, {produced[off - 1]}))")
                for (s, tt) in net.residual_edges:
                    if tt == i + off and s >= i:
                        h_s = net.map_shape(s)[0]
                        src = min(r * max(h_s // h[off], 1), h_s - 1)
                        s_off = s - i
                        if s_off < n_maps - 1:
                            live_s = produced[s_off] - caps[s_off]
                            if src < live_s or src >= produced[s_off]:
                                raise AssertionError(
                                    f"ring violation: residual source row "
                                    f"{src} of map {s} not resident "
                                    f"(have [{live_s}, {produced[s_off]}))")
                produced[off] += 1


# --------------------------------------------------------------------------
# Layer-Fusion square tiles (the paper's comparison baseline, §III-A/IV)
# --------------------------------------------------------------------------

def square_tile_halo_rows(net: NetSpec, i: int, j: int, t: int) -> list[int]:
    """Rows of L_l needed to produce a t x t output tile of L_j (same
    recurrence but *both* spatial dims are tiled, so halos are re-fetched /
    recomputed instead of kept)."""
    return span_row_counts(net, i, j, out_rows=t)


def square_tile_footprint_elems(net: NetSpec, i: int, j: int, t: int) -> int:
    """Footprint of Layer Fusion's t x t output tile: per layer the buffer is
    rows x cols x C with rows == cols (square), plus span weights."""
    counts = span_row_counts(net, i, j, out_rows=t)
    total = 0
    for off, rows in enumerate(counts):
        h, w, c = net.map_shape(i + off)
        cols = min(rows, w)
        total += rows * cols * c
    return total + net.span_weight_elems(i, j)


def max_square_tile(net: NetSpec, i: int, j: int, capacity: int,
                    batch: int = 1) -> int:
    """Largest square output tile side for Layer Fusion within capacity."""
    out_h, out_w, _ = net.map_shape(j)
    weights = net.span_weight_elems(i, j)
    lo, hi, best = 1, max(out_h, out_w), 0
    while lo <= hi:
        mid = (lo + hi) // 2
        fp = square_tile_footprint_elems(net, i, j, mid) - weights
        if batch * fp + weights <= capacity:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    return best


def recompute_factor_square(net: NetSpec, i: int, j: int, t: int) -> float:
    """Compute bloat of Layer Fusion's t x t tiles over exact execution.

    Layer Fusion scans tiles in row-major order and *caches the overlap in
    the scan direction* (its pyramid buffers), but the orthogonal halo was
    evicted with the previous tile row-band and must be *recomputed* — the
    paper's 'recomputation triggered by reuse not captured on-chip'. Per
    tile step, layer l therefore computes its full vertical extent
    (rows_out(l), halo included) over only the fresh columns (t * sigma(l),
    where sigma(l) is the cumulative stride from l+1 to the span output).
    Occam's full-row circular buffers never recompute (its necessary
    condition keeps every future-reuse row resident).

    Returns total-MACs(LF tiling) / total-MACs(exact) for the span, >= 1.
    """
    if t <= 0:
        return float("inf")
    out_h, out_w, _ = net.map_shape(j)
    n_tiles = -(-out_h // t) * (-(-out_w // t))
    exact = sum(net.layers[l].macs for l in range(i, j))
    tiled = 0.0
    # Rows of each layer's *output* needed per tile = row counts shifted by one.
    counts = span_row_counts(net, i, j, out_rows=t)  # inputs of layers i..j-1
    out_counts = counts[1:] + [t]  # outputs of layers i..j-1
    sigma = 1
    sigmas = []
    for l in range(j - 1, i - 1, -1):  # sigma(l) = prod strides of l+1..j-1
        sigmas.append(sigma)
        sigma *= net.layers[l].stride
    sigmas = list(reversed(sigmas))
    for off, l in enumerate(range(i, j)):
        layer = net.layers[l]
        if layer.kind != "conv":
            continue
        rows = min(out_counts[off], layer.out_h)       # vertical halo: recomputed
        fresh_cols = min(t * sigmas[off], layer.out_w)  # scan dir: cached overlap
        tiled += n_tiles * rows * fresh_cols * layer.out_ch \
            * layer.k * layer.k * layer.in_ch
    return max(tiled / exact, 1.0) if exact else 1.0

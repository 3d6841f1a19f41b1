"""Wrapper of the Hopper fused-span kernel (``csrc/fused_span.cu``).

The TPU kernel (``repro/kernels/fused_span/kernel.py``: ``_span_kernel``,
launched by ``_span_pallas`` through ``pl.pallas_call``) is generated and
unrolled per span. Compiling per span with nvcc would cost seconds each,
so the CUDA kernel is compiled once and reads a per-span *descriptor*:
map geometry, ring caps and ring offsets into the workspace, the residual
table, the spill list, the schedule's slot table and arrivals, and the
launch geometry, all int32. The descriptor is built from
``closure.span_schedule`` and :func:`span_geometry` once per (span,
spill, tile height, dtype, device) and cached with the device's answer
on cluster placement, so a launch does no host-side planning. The
pointers of one call (input, output, workspace, weights, biases,
residual sources, spills) travel by value as kernel parameters, so new
params or inputs never rebuild a descriptor.

Launch geometry (the plain functions :func:`row_tile` and
:func:`span_geometry`, checked on the CPU by the tests). One
thread-block cluster of 16 CTAs of 256 threads works on one image, or
of 8 CTAs where the device cannot place 16 or ``CLUSTER_SIZES`` pins 8:
a launch-shape choice, recorded in ``last_launch``. A CTA uses at most
128 registers and half an SM's shared memory, so two share an SM and a
batch of 8 clusters of 16 is resident at once. Each CTA owns a fixed
tile of every map's row, ``tw`` columns by ``tc`` channels, picked per
map so the cluster's tiles cover the row once with the least work on the
busiest CTA. A conv row is
an implicit GEMM over K = ``k * k * C_in``, staged through shared memory
in 2-4 chunks: as the CTA's input window, ``bk`` input channels a chunk,
where C_in is a multiple of 4 and the window holds fewer values than
im2col rows; else as im2col rows, ``bk`` K indices a chunk. K is split
over ``ks`` thread groups when the tile is small. A chunk's weights (B)
arrive by one TMA tile copy (:func:`tma_box`), through tensor maps encoded
here once per span plan and weight addresses; a tile is at most 256
channels, one box edge, and a conv whose C_out is not a multiple of 4
has its weights zero-padded per launch to rows of 16-byte multiples.
What bounds the kernel on the H100 and what the design does about it is
in the source's header note.

The rings live in a device-memory workspace of exactly
``batch x schedule.scratch_elems()`` elements, allocated here with
``torch.empty``; the kernel launches on the current stream, does not
synchronise, and ``counts`` (one :class:`Counts` record) counts its
launches and adds up, launch by launch, what one image of the span costs
(:func:`launch_counts`): the rows it produces and the cluster barriers it
waits at (:func:`span_counts`: one per input arrival and one per (step,
map) group of rows, so ``rows / barriers`` says how many rows a barrier
covers), and the bytes of weights its CTAs stage into shared memory. The
CTAs also add the bytes they stage to a device counter
(:func:`tma_tally`), which only tests read. A span the geometry cannot
serve (a kernel wider than 32, a row tile over 16 x 256 outputs or 256
channels, no cluster the device can place) raises; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import closure
from repro_torch.core.graph import NetSpec

from .. import _build


@dataclass
class Counts:
    """What launches of the kernel cost: ``launches``, and added launch by
    launch, what one image of each launch's span costs (as
    :func:`launch_counts` gives it): ``rows`` produced, cluster
    ``barriers`` waited at and ``weight_bytes`` of weights staged into
    shared memory."""
    launches: int = 0
    rows: int = 0
    barriers: int = 0
    weight_bytes: int = 0

    def add(self, other: "Counts") -> None:
        for name in self.__dataclass_fields__:
            setattr(self, name, getattr(self, name) + getattr(other, name))

    def __sub__(self, other: "Counts") -> "Counts":
        return Counts(*(getattr(self, name) - getattr(other, name)
                        for name in self.__dataclass_fields__))

    def copy(self) -> "Counts":
        return dataclasses.replace(self)

    def reset(self, to: "Counts | None" = None) -> None:
        """Set every count to ``to``'s, or to 0."""
        for name in self.__dataclass_fields__:
            setattr(self, name, 0 if to is None else getattr(to, name))


# the kernel's counts since import (or since the caller last reset them)
counts = Counts()
# the shape of the last launch: clusters, CTAs per cluster, threads, bytes
# of dynamic shared memory, how many clusters the device holds at once,
# and one image's rows, cluster barriers and weight bytes
last_launch: dict = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pointer-table sizes of the kernel's by-value SpanPtrs
MAX_CONV, MAX_SRC, MAX_SPILL = 128, 8, 8

# field counts of the descriptor records (csrc/fused_span.cu enums)
_H_LEN, _M_LEN, _R_LEN = 14, 20, 5

# launch geometry (csrc/fused_span.cu constants)
THREADS = 256            # threads per CTA (kThreads)
MICRO = 4                # a thread's register tile: 4 columns x 4 channels
MAX_K = 32               # widest conv or pool window the geometry takes
MAX_TAPS = 128           # most taps (k * k) of a window-staged conv
MAX_BK = 512             # largest K-chunk (a power of two)
MAX_STAGES = 4           # K-chunks held in shared memory at once
TMA_BOX_MAX = 256        # longest edge of a TMA box (kBoxMax)
ALIGN = 32               # floats: TMA lands B 128-byte aligned (kAlign)
MBARRIER = 8             # bytes of an mbarrier
SMEM_LIMIT = 232_448     # shared memory a CTA may use on the H100
# the kernel's static shared memory: the tap table, the TMA byte sum and
# a K-chunk stage's mbarrier each
STATIC_SMEM = 4 * MAX_TAPS + 8 + MAX_STAGES * MBARRIER
# dynamic shared memory per CTA, so two CTAs share an SM's 228 KB; the
# K-chunks leave DESC_RESERVE of it to the descriptor's copy
SMEM_BUDGET = 114_688
DESC_RESERVE = 2_048
# the cluster sizes tried, largest first, read when a span's launch plan
# is built: assign (8,) to pin clusters of 8 CTAs
CLUSTER_SIZES = (16, 8)

_plans: dict = {}
_cluster_choice: dict = {}
# per device, the bytes the CTAs have staged by TMA (int64, on the device)
_tallies: dict = {}


@dataclass(frozen=True)
class RowTile:
    """A CTA's share of one map's rows: ``tw`` columns x ``tc`` channels,
    ``n_wt`` x ``n_ct`` tiles per row (rank -> tile ``(rank // n_ct,
    rank % n_ct)``). For a conv, how A is staged (``window``: the input
    window, K chunked over input channels; else im2col, K chunked as is),
    the chunk ``bk`` (input channels, or K indices), the K-split groups
    ``ks``, the chunks held in shared memory ``stages``, and ``smem`` the
    dynamic shared memory it needs (bytes)."""
    tw: int
    tc: int
    n_wt: int
    n_ct: int
    bk: int = 0
    ks: int = 0
    stages: int = 0
    smem: int = 0
    window: bool = False

    def tiles(self, cluster: int, w: int, c: int):
        """(x0, nx, c0, nc) of each rank's tile, empty ones included."""
        out = []
        for rank in range(cluster):
            x0 = (rank // self.n_ct) * self.tw
            c0 = (rank % self.n_ct) * self.tc
            out.append((x0, max(0, min(self.tw, w - x0)), c0,
                        max(0, min(self.tc, c - c0))))
        return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _align(n: int) -> int:
    return _ceil(n, ALIGN) * ALIGN


def _stage_floats(twp: int, tc: int, k: int, stride: int, bk: int,
                  window: bool) -> tuple[int, int]:
    """(B's offset, the stage's size) of one K-chunk in shared memory, in
    fp32 elements: the A part (the window W[k][(twp - 1) * stride + k][bk
    + 4], or im2col A[twp][bk + 4]) padded to 128 bytes, so that B[kc][tc]
    (kc = k * k * bk or bk K indices) starts where a TMA copy may land,
    and the stage padded to 128 bytes, so that the next one does too."""
    if window:
        a = k * ((twp - 1) * stride + k) * (bk + MICRO)
    else:
        a = twp * (bk + MICRO)
    kc = k * k * bk if window else bk
    return _align(a), _align(_align(a) + kc * tc)


def _stage_bytes(twp: int, tc: int, k: int, stride: int, bk: int,
                 window: bool) -> int:
    """One K-chunk in shared memory, in bytes (:func:`_stage_floats`)."""
    return 4 * _stage_floats(twp, tc, k, stride, bk, window)[1]


def row_tile(kind: str, k: int, c_in: int, w: int, c: int,
             cluster: int, stride: int = 1) -> RowTile:
    """The tile of a ``w`` x ``c`` output row for each CTA of a cluster.

    Channel tiles are multiples of 4 (a thread's register tile) and at
    most ``TMA_BOX_MAX`` (one TMA box edge); among the tilings with at
    most ``cluster`` tiles, the one with the least
    padded work on one CTA wins, then the one staging the fewest A and B
    values per K index. A conv's K-chunk and stage count keep the most of
    K in as few chunks as ``SMEM_BUDGET - DESC_RESERVE`` holds, then as
    many of them in flight as fit. A row's K-split sums share the stage
    of its last chunk, or follow the stages where they do not fit one,
    so the next row's chunks stay in flight meanwhile. Raises ValueError
    when no tiling fits 16 x 256 outputs (a 4 x 4 register tile per
    thread) and 256 channels per CTA, or the window is wider than the
    kernel takes."""
    if k > MAX_K:
        raise ValueError(f"{kind} window {k} is wider than the fused-span "
                         f"kernel's {MAX_K}")
    best = None
    for tc in range(MICRO, min(_ceil(c, MICRO) * MICRO, TMA_BOX_MAX) + 1,
                    MICRO):
        n_ct = _ceil(c, tc)
        if n_ct > cluster:
            continue
        tw = _ceil(w, cluster // n_ct)
        twp = _ceil(tw, MICRO) * MICRO
        if twp * tc > THREADS * MICRO * MICRO:
            continue
        key = (twp * tc, twp + tc)
        if best is None or key < best[0]:
            best = (key, tw, tc, _ceil(w, tw), n_ct)
    if best is None:
        raise ValueError(f"no tiling of a {w} x {c} row over {cluster} CTAs "
                         f"fits {THREADS * MICRO * MICRO} outputs and "
                         f"{TMA_BOX_MAX} channels per CTA")
    _key, tw, tc, n_wt, n_ct = best
    if kind != "conv":
        return RowTile(tw, tc, n_wt, n_ct)
    twp, kdim = _ceil(tw, MICRO) * MICRO, k * k * c_in
    # the window stages each input value once, im2col once per tap: the
    # window wins for k > 1 when C_in allows 16-byte channel groups
    window = (c_in % MICRO == 0 and k * k <= MAX_TAPS
              and (twp - 1) * stride + k < twp * k)
    span = c_in if window else kdim  # what the chunks split
    choice = None
    bk = MICRO
    while bk <= min(MAX_BK, max(MICRO, 1 << (span - 1).bit_length())):
        kc = k * k * bk if window else bk
        ks = min(THREADS // ((twp // MICRO) * (tc // MICRO)), kc // MICRO)
        stage = _stage_bytes(twp, tc, k, stride, bk, window)
        red = ks * twp * tc * 4
        for stages in range(2, MAX_STAGES + 1):
            smem = stages * stage + (red if red > stage else 0)
            if smem > SMEM_BUDGET - DESC_RESERVE:
                break
            # fewest chunks first (each costs a round trip), then depth
            key = (min(bk, span), stages)
            if choice is None or key > choice[0]:
                choice = (key, RowTile(tw, tc, n_wt, n_ct, bk, ks, stages,
                                       smem, window))
        bk *= 2
    if choice is None:
        raise ValueError(f"a {k}x{k} conv tile of {tw} x {tc} outputs does "
                         f"not fit {SMEM_BUDGET - DESC_RESERVE} bytes of "
                         f"shared memory")
    return choice[1]


@dataclass(frozen=True)
class SpanGeometry:
    """The launch geometry of one span: one cluster of ``cluster`` CTAs
    per image, ``THREADS`` threads each, ``smem`` bytes of shared memory
    for the K-chunks (the launch adds the descriptor's copy, see
    :func:`launch_smem`), and each map's :class:`RowTile` (``None`` for
    the input)."""
    cluster: int
    smem: int
    tiles: tuple


def span_geometry(net: NetSpec, a: int, b: int,
                  cluster: int = CLUSTER_SIZES[0]) -> SpanGeometry:
    """Each map's row tile of SPAN(a, b) for clusters of ``cluster``."""
    tiles = [None]
    for layer in net.layers[a:b]:
        tiles.append(row_tile(layer.kind, layer.k, layer.in_ch,
                              layer.out_w, layer.out_ch, cluster,
                              layer.stride))
    smem = max([16] + [t.smem for t in tiles[1:]])
    return SpanGeometry(cluster, smem, tuple(tiles))


def tma_box(layer, tile: RowTile) -> tuple[int, ...] | None:
    """The box of one TMA copy of a conv's K-chunk of B, innermost edge
    first; None for a pool.

    The box is ``(tc, bk, k * k)`` of the (k * k, C_in, C_out) weights in
    window mode, ``(tc, bk)`` of the (K, C_out) matrix in im2col mode
    (``tc`` is a multiple of 4 channels and at most 256, see
    :func:`row_tile`); an edge over 256 (``bk`` 512) is cut to 256 and the
    chunk takes two copies (two a tap in window mode, whose box is then
    one tap deep)."""
    if layer.kind != "conv":
        return None
    bk = min(tile.bk, TMA_BOX_MAX)
    if tile.window:
        return (tile.tc, bk, layer.k ** 2 if tile.bk <= TMA_BOX_MAX else 1)
    return (tile.tc, bk)


def span_counts(schedule: closure.SpanSchedule) -> tuple[int, int]:
    """(rows, cluster barriers) of one image of a span's launch: every row
    the schedule produces, and a barrier for each input arrival and each
    (step, map) group, the step's rows of one map, which the kernel
    produces back to back."""
    groups = [ops for step in schedule.steps for ops in step if ops]
    arrivals = sum(blk >= 0 for blk in schedule.arrivals)
    return sum(map(len, groups)), len(groups) + arrivals


def launch_counts(net: NetSpec, a: int, b: int,
                  schedule: closure.SpanSchedule,
                  geom: SpanGeometry) -> Counts:
    """What one image of a launch of SPAN(a, b) costs, as :class:`Counts`
    (``launches`` 1).

    ``weight_bytes`` is a host model of how ``conv_group`` in
    ``csrc/fused_span.cu`` stages B, by the TMA boxes of ``load_b_tma``
    (:func:`tma_box`), and has to change with them: for every row of a
    conv map the schedule produces, each CTA with a tile of the row
    stages its C_out slice of the (k * k * C_in, C_out) fp32 weight
    matrix, K deep, into shared memory. Only in-range bytes count: a
    box's part past K or past the slice is a zero fill and moves
    nothing, and the biases, staged once a group, are left out. The CTAs
    also sum these bytes on the device (:func:`tma_tally`)."""
    n_rows, n_barriers = span_counts(schedule)
    weight = 0
    for off, layer in enumerate(net.layers[a:b], start=1):
        if layer.kind != "conv":
            continue
        staged = sum(nc for _x0, nx, _c0, nc in geom.tiles[off].tiles(
            geom.cluster, layer.out_w, layer.out_ch) if nx > 0 and nc > 0)
        produced = sum(len(step[off - 1]) for step in schedule.steps)
        weight += produced * layer.k * layer.k * layer.in_ch * staged * 4
    return Counts(1, n_rows, n_barriers, weight)


def _descriptor(net: NetSpec, a: int, b: int,
                schedule: closure.SpanSchedule, spill: tuple[int, ...],
                src_keys: tuple[int, ...],
                cluster: int = CLUSTER_SIZES[0]) -> list[int]:
    """The int32 descriptor the kernel reads for SPAN(a, b)."""
    geom = span_geometry(net, a, b, cluster)
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
        tile = [0] * 7
        if off > 0:
            layer = net.layers[m - 1]
            kind = 0 if layer.kind == "conv" else 1
            k, stride, pad = layer.k, layer.stride, layer.padding
            if layer.kind == "conv":
                conv, n_conv = n_conv, n_conv + 1
            edges = [s for (s, t) in net.residual_edges if t == m]
            t = geom.tiles[off]
            tile = [t.tw, t.tc, t.n_ct, t.bk, t.ks, t.stages, int(t.window)]
        cap = schedule.ring_caps[off] if off < n_maps - 1 else 0
        res0 = len(res) // _R_LEN
        for s in edges:
            src = [1, src_keys.index(s)] if s < a else [0, s - a]
            res += src + list(net.map_shape(s))
        maps += [kind, k, stride, pad, h, w, c, cap, ring_off, res0,
                 len(edges), spill.index(m) if m in spill else -1,
                 conv] + tile
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
    # shared memory: the descriptor up to its table, the step's table row,
    # the biases of the widest conv tile (4-int aligned), then the K-chunks
    # (128-byte aligned, for TMA)
    row = _ceil(offsets[-1], 4) * 4
    bias = row + _ceil(schedule.total_slots, 4) * 4
    stage = _align(bias + _ceil(max([t.tc for t in geom.tiles[1:]]), 4) * 4)
    header = [n_maps, schedule.in_rows, schedule.n_steps,
              schedule.total_slots, len(res) // _R_LEN, cluster, row, bias,
              stage] + offsets
    return header + [v for part in body for v in part]


def launch_smem(geom: SpanGeometry, desc: list[int]) -> int:
    """Dynamic shared memory of a launch: the descriptor's copy, the table
    row and biases (``desc``'s stage offset), then the K-chunks."""
    return 4 * desc[8] + geom.smem


def _max_clusters(dtype: int, cluster: int, smem: int,
                  device: torch.device) -> int:
    """How many clusters of ``cluster`` CTAs the device holds at once."""
    fn = _build.library("fused_span").occam_fused_span_max_clusters
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, ctypes.POINTER(i)]
        fn.restype = i
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(dtype, cluster, smem, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"fused-span occupancy query failed: CUDA error "
                           f"{rc}")
    return count.value


class _BMaps:
    """The TMA tensor maps of a span's conv weights (128 bytes each, in
    conv order). A map holds the weights' address, so the maps are
    encoded once per set of weight addresses and the last few sets kept:
    a session's replays and an eager caller's fixed weights do no host
    work for them."""

    KEEP = 8

    def __init__(self, specs: list):
        # per conv, (window, k, C_in, C_out, tc, bk)
        self.specs = specs
        self._by_ptrs: dict = {}

    def get(self, weights: list[torch.Tensor]) -> ctypes.Array:
        key = tuple(w.data_ptr() for w in weights)
        maps = self._by_ptrs.pop(key, None)
        if maps is None:
            maps = (ctypes.c_ubyte * (128 * max(len(weights), 1)))()
            encode = _build.library("fused_span").occam_fused_span_encode_b_map
            if encode.argtypes is None:
                i = ctypes.c_int
                encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i, i, i,
                                   i, i, i]
                encode.restype = i
            for n, (spec, w) in enumerate(zip(self.specs, weights)):
                rc = encode(ctypes.addressof(maps) + 128 * n, w.data_ptr(),
                            *spec)
                if rc != 0:
                    raise RuntimeError(f"encoding conv {n}'s TMA tensor map "
                                       f"failed: CUresult {rc}")
        self._by_ptrs[key] = maps
        if len(self._by_ptrs) > self.KEEP:
            self._by_ptrs.pop(next(iter(self._by_ptrs)))
        return maps


def tma_weights(w: torch.Tensor) -> torch.Tensor:
    """A conv's (k, k, C_in, C_out) weights as its TMA tensor map reads
    them: fp32, contiguous, on a 16-byte-aligned base, each row of C_out
    channels zero-padded to a multiple of 4 (16 bytes, the row stride TMA
    takes; the map's C_out extent leaves the pad unread). ``w`` itself
    where it already is so, else a fresh tensor made on the current
    stream, so a CUDA graph's capture records the pad and every replay
    pads again from the step's params."""
    w = w.to(torch.float32).contiguous()
    if w.shape[-1] % 4:
        w = torch.nn.functional.pad(w, (0, -w.shape[-1] % 4))
    # a fresh tensor's base is 16-byte aligned
    return w if w.data_ptr() % 16 == 0 else w.clone()


def tma_tally(device) -> int:
    """The bytes of weights the kernel's CTAs have staged by TMA on
    ``device`` since its first span plan there, summed on the device
    (each CTA adds its in-range box bytes at its end). Reading it
    synchronises the device: tests and ``chip_smoke.py`` read it, never
    the served path. Per launch it is the batch times
    ``launch_counts(...).weight_bytes``."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    tally = _tallies.get(device)
    return 0 if tally is None else int(tally.item())


def _span_plan(net: NetSpec, a: int, b: int, spill: tuple[int, ...],
               out_rows: int, src_keys: tuple[int, ...], dtype: torch.dtype,
               device: torch.device):
    """(workspace elems per image, geometry, launch shared memory, resident
    clusters, device descriptor, :func:`launch_counts`, :class:`_BMaps`)
    of one span, built once per (span, spill, tile height, dtype, device,
    cluster sizes) and cached: a launch then does no schedule or geometry
    work on the host. The first plan on a device makes its TMA byte
    counter (:func:`tma_tally`), so a capture, which follows a warm-up
    call, finds it.

    The geometry is the one for the largest size in ``CLUSTER_SIZES`` the
    device can place (16, else 8); RuntimeError when it can place none,
    ValueError when the span needs more shared memory than a CTA has or
    ``CLUSTER_SIZES`` names a size other than 16 or 8."""
    sizes = tuple(CLUSTER_SIZES)
    if not sizes or any(c not in (16, 8) for c in sizes):
        raise ValueError(f"CLUSTER_SIZES must list sizes among (16, 8), "
                         f"got {sizes}")
    key = (net, a, b, spill, out_rows, dtype, device, sizes)
    plan = _plans.get(key)
    if plan is not None:
        return plan
    schedule = closure.span_schedule(net, a, b, spill=spill,
                                     out_rows=out_rows)
    for cluster in sizes:
        geom = span_geometry(net, a, b, cluster)
        words = _descriptor(net, a, b, schedule, spill, src_keys, cluster)
        smem = launch_smem(geom, words)
        if smem + STATIC_SMEM > SMEM_LIMIT:
            raise ValueError(f"span ({a}, {b}) needs {smem} bytes of shared "
                             f"memory per CTA; the H100 has "
                             f"{SMEM_LIMIT - STATIC_SMEM}")
        query = (_DTYPE_CODES[dtype], cluster, smem, device)
        if query not in _cluster_choice:
            _cluster_choice[query] = _max_clusters(*query)
        resident = _cluster_choice[query]
        if resident >= 1:
            desc = torch.tensor(words, dtype=torch.int32, device=device)
            specs = [(int(t.window), layer.k, layer.in_ch, layer.out_ch,
                      t.tc, t.bk)
                     for layer, t in zip(net.layers[a:b], geom.tiles[1:])
                     if layer.kind == "conv"]
            if device not in _tallies:
                _tallies[device] = torch.zeros(1, dtype=torch.int64,
                                               device=device)
            plan = _plans[key] = (
                schedule.scratch_elems(), geom, smem, resident, desc,
                launch_counts(net, a, b, schedule, geom), _BMaps(specs))
            return plan
    raise RuntimeError(f"span ({a}, {b}): the device places no cluster of "
                       f"{' or '.join(map(str, sizes))} CTAs with "
                       f"{smem} bytes of shared memory each")


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
                       p, i, i, i, p]
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
    tensor, an unsupported dtype, a span outside the launch geometry, or a
    failed build or launch.
    """
    spill = tuple(sorted(set(spill)))
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
            w_list.append(tma_weights(p["w"].to(dev, torch.float32)))
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
    plan = _span_plan(net, a, b, spill, out_rows, src_keys, xs.dtype, dev)
    per_image, geom, smem, resident, desc, cost, b_maps = plan
    workspace = torch.empty(batch * per_image, dtype=xs.dtype, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(_DTYPE_CODES[xs.dtype], desc.data_ptr(), xs.data_ptr(),
                    out.data_ptr(), workspace.data_ptr(), per_image,
                    _ptr_array(b_list), b_maps.get(w_list), len(w_list),
                    _ptr_array(src_list), len(src_list),
                    _ptr_array(spills), len(spills),
                    _tallies[dev].data_ptr(), batch,
                    geom.cluster, smem, stream)
    if rc != 0:
        raise RuntimeError(f"fused-span kernel launch failed: CUDA error {rc}")
    counts.add(cost)
    last_launch.clear()
    last_launch.update(clusters=batch, cluster=geom.cluster,
                       ctas=batch * geom.cluster, threads=THREADS,
                       smem=smem, resident_clusters=resident, rows=cost.rows,
                       barriers=cost.barriers, weight_bytes=cost.weight_bytes)
    return out, dict(zip(spill, spills))


def span_kernel_scratch_elems(net: NetSpec, a: int, b: int,
                              out_rows: int = 1) -> tuple[int, int]:
    """(ring workspace elems per image, weight elems) of the CUDA kernel.

    The workspace is exactly |DC(a, b)| at the given tile height, and the
    sum equals ``span_footprint_elems``: the twin of the reference's
    ``span_kernel_vmem_elems``."""
    schedule = closure.span_schedule(net, a, b, out_rows=out_rows)
    return schedule.scratch_elems(), net.span_weight_elems(a, b)

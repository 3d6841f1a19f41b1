"""The fused-span kernel's counts (``kernel.Counts``) on the CPU.

One launch's rows, cluster barriers and staged weight bytes
(``kernel.launch_counts``) against a hand count, its weight bytes against
a replay of the TMA boxes ``conv_group`` issues, and those boxes, read
from the padded weights, against B; the benchmark plans' counts; the
record's arithmetic; a serving step adding its recorded counts once a
replay; and the round span carrying the weight bytes and the
deployment's boundary bytes per image. The counts of a launch on the card
are tested in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import occam
from repro_torch.core import closure
from repro_torch.core.graph import chain
from repro_torch.kernels.fused_span import kernel
from repro_torch.models import zoo
from repro_torch.occam import deploy, trace
from repro_torch.runtime import span_engine
from test_torch_cuda import CASES as CUDA_CASES

C, P = "conv", "pool"
CAPACITY = 3_145_728
# span (1, 4): edge (0, 2) crosses in from device memory, (1, 4) reads
# ring 0, and (2, 5) leaves the span, so map 2 spills
RES_SPILL = chain("res-src-spill", [(C, 3, 1, 1, 4)] * 3
                  + [(C, 3, 2, 1, 8), (C, 3, 1, 1, 8)], in_h=10, in_w=10,
                  in_ch=3, residual_edges=((0, 2), (1, 4), (2, 5)))


def _counts(net, a, b, spill=(), out_rows=1,
            cluster=kernel.CLUSTER_SIZES[0]):
    sched = closure.span_schedule(net, a, b, spill=spill, out_rows=out_rows)
    return kernel.launch_counts(net, a, b, sched,
                                kernel.span_geometry(net, a, b, cluster))


@pytest.mark.parametrize("out_rows", [1, 2])
def test_launch_counts_equal_a_hand_count(out_rows):
    """Span (1, 4) of a net with a spill and a crossing source, clusters
    of 16: maps 2 and 3 are 10 x 10 x 4 and map 4 is 5 x 5 x 8; every
    row of each is produced once. A 10-wide row of 4 channels gives ten
    CTAs a one-column tile each, a 5-wide row of 8 channels ten CTAs a
    column of 4 channels, so every CTA with a tile stages its 4 channels
    of the 36-deep weights once a row, however many rows a tile holds."""
    c = _counts(RES_SPILL, 1, 4, spill=(2,), out_rows=out_rows)
    rows = 10 + 10 + 5
    assert (c.launches, c.rows) == (1, rows)
    assert c.barriers == kernel.span_counts(closure.span_schedule(
        RES_SPILL, 1, 4, spill=(2,), out_rows=out_rows))[1]
    # rows x CTAs with a tile x 4 channels x K = 36 x 4 bytes
    assert c.weight_bytes == (10 * 10 + 10 * 10 + 5 * 10) * 4 * 36 * 4


def _boxed_bytes(layer, t, cluster):
    """One row's in-range bytes of the TMA boxes ``conv_group``'s
    ``load_b_tma`` issues over every CTA and K-chunk, replayed from its
    loops: a box edge is at most 256 K rows (a 512-deep chunk takes two,
    in window mode two a tap), and a box's rows past C_in (or K) and
    channels past the CTA's ``nc`` are zero fills that move no byte."""
    k, c_in = layer.k, layer.in_ch
    kdim = k * k * c_in
    n_chunks = -(-c_in // t.bk) if t.window else -(-kdim // t.bk)
    bkb = min(t.bk, 256)
    total = 0
    for _x0, nx, _c0, nc in t.tiles(cluster, layer.out_w, layer.out_ch):
        if nx <= 0 or nc <= 0:
            continue
        for c in range(n_chunks):
            k0 = c * t.bk
            for h in range(0, t.bk, 256):
                if t.window:
                    rows = max(0, min(bkb, c_in - k0 - h)) * k * k
                else:
                    rows = max(0, min(bkb, kdim - k0 - h))
                total += rows * nc * 4
    return total


def _plan_spans(name):
    """(net, [(a, b, spill)]) of a benchmark plan or a GPU case."""
    if name in ("vggnet", "resnet18", "alexnet"):
        net = getattr(zoo, name)()
        plan = occam.plan(net, CAPACITY)
        return net, [(r.start, r.end, span_engine.span_spills(
            net, plan.boundaries, r.start, r.end)) for r in plan.routes]
    _n, specs, hw, ch, edges, span = {c[0]: c for c in CUDA_CASES}[name]
    net = chain(name, specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    a, b = span or (0, net.n_layers)
    cuts = [c for c in (a, b) if 0 < c < net.n_layers]
    return net, [(a, b, span_engine.span_spills(net, cuts, a, b))]


@pytest.mark.parametrize("cluster", kernel.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["vggnet", "resnet18", "alexnet"]
                         + [c[0] for c in CUDA_CASES])
def test_weight_bytes_replay_the_boxes_of_conv_group(name, cluster):
    """For every span of the benchmark plans and of the GPU parity cases,
    the counted weight bytes equal the in-range bytes of the boxes
    ``load_b_tma`` issues: each conv row the schedule produces, times its
    boxes over the CTAs and K-chunks."""
    net, spans = _plan_spans(name)
    for a, b, spill in spans:
        sched = closure.span_schedule(net, a, b, spill=spill)
        geom = kernel.span_geometry(net, a, b, cluster)
        want = 0
        for off, layer in enumerate(net.layers[a:b], start=1):
            if layer.kind == "conv":
                # rows no later row reads are not produced (a stem whose
                # pool leaves its last row unread)
                produced = sum(len(step[off - 1]) for step in sched.steps)
                assert produced <= net.map_shape(a + off)[0]
                want += produced * _boxed_bytes(layer, geom.tiles[off],
                                                cluster)
        got = kernel.launch_counts(net, a, b, sched, geom)
        assert got.weight_bytes == want > 0, (name, a, b)


def _box_copies(layer, t, c, c0, weights):
    """Stage B of K-chunk ``c`` of the CTA whose channels start at ``c0``,
    as ``load_b_tma``'s boxes (:func:`kernel.tma_box`) land it: the
    tensor map's view of the flat ``weights`` (rows of ``weights``' last
    dimension, extents the true (C_out, C_in or K, k * k)), each box's
    elements past an extent zero-filled. NaN where no box lands."""
    k, c_in, c_out = layer.k, layer.in_ch, layer.out_ch
    pitch = weights.shape[-1]
    flat = weights.reshape(-1)
    box = kernel.tma_box(layer, t)
    kc = k * k * t.bk if t.window else t.bk
    bs = np.full(kc * t.tc, np.nan, np.float32)
    dims = (c_out, c_in, k * k) if t.window else (c_out, k * k * c_in, 1)
    depth = box[2] if t.window else 1
    k0 = c * t.bk
    z, y, x = np.ix_(range(depth), range(box[1]), range(box[0]))
    for t0 in range(0, k * k if t.window else 1, depth):
        for h in range(0, t.bk, box[1]):
            gx, gy, gz = c0 + x, k0 + h + y, t0 + z
            ok = (gx < dims[0]) & (gy < dims[1]) & (gz < dims[2])
            idx = np.where(ok, (gz * c_in + gy) * pitch + gx, 0)
            dst = (t0 * t.bk + h) * t.tc
            bs[dst:dst + ok.size] = np.where(ok, flat[idx], 0.0).reshape(-1)
    return bs.reshape(kc, t.tc)


@pytest.mark.parametrize("cluster", kernel.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["vggnet", "resnet18", "alexnet"]
                         + [c[0] for c in CUDA_CASES])
def test_boxes_read_b_from_the_padded_weights(name, cluster):
    """For every conv of the benchmark plans and of the GPU parity cases
    (``cout-2-mod-4``'s C_out of 6 and 10 included), the weights as the
    tensor map reads them (:func:`kernel.tma_weights`: rows padded to a
    multiple of 4 channels, 16-byte aligned) and each CTA's boxes of the
    first and the last K-chunk land B exactly: the K-chunk's rows of the
    unpadded (k * k * C_in, C_out) weights at the CTA's channels, zero
    past C_in (or K) and past C_out."""
    net, spans = _plan_spans(name)
    rng = np.random.default_rng(0)
    for a, b, _spill in spans:
        geom = kernel.span_geometry(net, a, b, cluster)
        for off, layer in enumerate(net.layers[a:b], start=1):
            if layer.kind != "conv":
                continue
            t = geom.tiles[off]
            k, c_in, c_out = layer.k, layer.in_ch, layer.out_ch
            w = rng.standard_normal((k, k, c_in, c_out), np.float32)
            padded = kernel.tma_weights(torch.from_numpy(w))
            assert padded.shape == (k, k, c_in, -(-c_out // 4) * 4)
            assert padded.data_ptr() % 16 == 0 and padded.is_contiguous()
            w2 = w.reshape(k * k * c_in, c_out)
            n_chunks = -(-c_in // t.bk) if t.window \
                else -(-k * k * c_in // t.bk)
            for _x0, nx, c0, nc in t.tiles(cluster, layer.out_w, c_out):
                if nx <= 0 or nc <= 0:
                    continue
                for c in sorted({0, n_chunks - 1}):
                    got = _box_copies(layer, t, c, c0, padded.numpy())
                    want = np.zeros_like(got)
                    kk = np.arange(got.shape[0])
                    if t.window:
                        ci = c * t.bk + kk % t.bk
                        rows = kk // t.bk * c_in + ci
                        ok = ci < c_in
                    else:
                        rows = c * t.bk + kk
                        ok = rows < k * k * c_in
                    want[ok, :nc] = w2[rows[ok], c0:c0 + nc]
                    np.testing.assert_array_equal(got, want)


# what one image of each benchmark plan costs: the kernel's launches,
# rows, barriers and weight bytes, and the deployment's boundary bytes
# (the plan's feature traffic)
PLAN_COUNTS = {
    "vggnet": ([6, 11, 12, 13, 14, 16, 17, 18, 19],
               kernel.Counts(10, 1_281, 891, 3_051_159_552), 18_364_416),
    "resnet18": ([12, 15, 16, 17],
                 kernel.Counts(5, 588, 229, 487_538_688), 2_207_744),
    "alexnet": ([], kernel.Counts(1, 167, 49, 154_581_504), 655_212),
}


@pytest.mark.parametrize("name", sorted(PLAN_COUNTS))
def test_plan_counts_sum_to_its_predicted_feature_traffic(name):
    """Over the spans of a benchmark plan the kernel's counts are what the
    metrics of the batch cells read, and the deployment's per-image
    transfer profile, which the round span carries as its boundary
    bytes, is the plan's predicted feature traffic in fp32 (VGG-19:
    4,591,104 elements, 18.36 MB an image)."""
    net = getattr(zoo, name)()
    plan = occam.plan(net, CAPACITY)
    cuts, want, boundary = PLAN_COUNTS[name]
    assert plan.boundaries == cuts
    total = kernel.Counts()
    for r in plan.routes:
        total.add(_counts(net, r.start, r.end, span_engine.span_spills(
            net, plan.boundaries, r.start, r.end)))
    assert total == want
    per = plan.place().compile(device="cpu")._per_image_profile()
    assert per.total_bytes == boundary == plan.predicted.feature_elems * 4


def test_counts_record_adds_subtracts_and_resets():
    c = kernel.Counts()
    one = kernel.Counts(1, 7, 3, 100)
    c.add(one)
    c.add(one)
    assert c == kernel.Counts(2, 14, 6, 200)
    before = c.copy()
    c.add(kernel.Counts(1, 1, 1, 1))
    assert c - before == kernel.Counts(1, 1, 1, 1)
    assert before == kernel.Counts(2, 14, 6, 200)
    c.reset(before)
    assert c == before and c is not before
    c.reset()
    assert dataclasses.astuple(c) == (0, 0, 0, 0)


class _Graph:
    """A captured graph's stand-in: a replay does nothing."""

    replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def small():
    net = chain("t", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 1, 1, 8)],
                in_h=8, in_w=8, in_ch=3)
    rng = np.random.default_rng(0)
    params = [{"w": torch.from_numpy(rng.standard_normal(
        (ly.k, ly.k, ly.in_ch, ly.out_ch), np.float32)),
               "b": torch.zeros(ly.out_ch)} if ly.kind == C else {}
              for ly in net.layers]
    dep = occam.plan(net, 4000).place().compile(device="cpu")
    xs = torch.from_numpy(rng.standard_normal((3, 8, 8, 3), np.float32))
    return dep, params, xs


def test_a_replay_adds_the_recorded_counts_once(small):
    """Each replay of a serving step adds its recorded ``per_replay`` to
    the kernel's counts once, whatever the lanes it carries."""
    dep, params, xs = small
    step = deploy._RoundStep(dep, 2)
    assert step.per_replay == kernel.Counts()
    step.per_replay = kernel.Counts(2, 40, 12, 5_000)
    step.graph = _Graph()
    step._params = step._bound = params
    step._x = torch.zeros((2, 8, 8, 3))
    step._y = torch.zeros((2, 4, 4, 8))
    before = kernel.counts.copy()
    try:
        step(params, xs[:2])
        step(params, xs[2:])
        assert step.graph.replays == 2
        assert kernel.counts - before == kernel.Counts(4, 80, 24, 10_000)
    finally:
        kernel.counts.reset(before)


def test_round_span_carries_the_counts_per_image(small):
    """While a profiler records, every round carries the deployment's
    boundary bytes per image on ``occam.session.round``, and a round that
    launches the kernel its step's weight bytes per image; a round on the
    CPU's plain path launches nothing and carries none."""
    dep, params, xs = small
    boundary = dep._per_image_profile().total_bytes
    assert boundary == dep.plan.predicted.feature_elems * 4
    trace.clear()
    try:
        for per in (kernel.Counts(), kernel.Counts(2, 40, 12, 5_000)):
            with dep.serve(params, round_batch=2) as sess:
                sess._step.per_replay = per
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    sess.submit(xs)
                    sess.results()
            rounds = [r for r in trace.records()
                      if r.name == "occam.session.round"]
            trace.clear()
            assert [r.attrs["lanes"] for r in rounds] == [2, 1]
            for r in rounds:
                assert "weight_tma_bytes" not in r.attrs
                got = (r.attrs.get("weight_bytes"),
                       r.attrs.get("boundary_bytes"))
                assert got == (5_000 if per.launches else None, boundary)
    finally:
        trace.clear()

"""The port's fused-span module against the reference's: the rowops twins,
``span_forward`` on CPU tensors (the kernel's plain version) against the
reference kernel in interpret mode, the validation errors and the
workspace size, and the CUDA kernel's launch geometry. The CUDA kernel
itself is tested in test_torch_cuda.py."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import chain as j_chain
from repro.kernels.fused_span import rowops as j_rowops
from repro.kernels.fused_span.kernel import span_kernel_vmem_elems
from repro.kernels.fused_span.ops import fused_span as j_fused_span
from repro.kernels.fused_span.ops import span_forward as j_span_forward
from repro_torch import convert, occam
from repro_torch.core import closure
from repro_torch.core.graph import chain
from repro_torch.kernels.fused_span import kernel, rowops
from repro_torch.kernels.fused_span.ops import (fused_span, fused_span_ref,
                                                span_forward,
                                                span_kernel_scratch_elems)
from repro_torch.models import cnn, zoo
from repro_torch.runtime import span_engine
from test_torch_cuda import CASES as CUDA_CASES

C, P = "conv", "pool"
TOL = dict(rtol=1e-4, atol=1e-4)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# (name, specs, hw, in_ch, residual edges, span, out_rows)
CASES = [
    ("k1-s1", [(C, 1, 1, 0, 4), (C, 1, 1, 0, 8)], 8, 3, (), None, 1),
    ("k3-s2", [(C, 3, 2, 1, 4), (C, 3, 1, 1, 8)], 10, 3, (), None, 1),
    ("conv-pool-s2", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 2, 1, 8)],
     12, 3, (), None, 2),
    ("pool-k3-s2-pad", [(C, 3, 1, 1, 4), (P, 3, 2, 1, 0)], 9, 3, (), None,
     1),
    # span (1, 4): (0, 2) crosses in from memory, (1, 4) adds from ring 0,
    # (2, 5) leaves the span so map 2 spills; stride-2 option-A shortcut
    ("res-src-spill", [(C, 3, 1, 1, 4)] * 3 + [(C, 3, 2, 1, 8),
                                                (C, 3, 1, 1, 8)],
     10, 3, ((0, 2), (1, 4), (2, 5)), (1, 4), 2),
]


def numpy_params(net, seed):
    rng = np.random.default_rng(seed)
    params = []
    for layer in net.layers:
        if layer.kind == "conv":
            params.append({
                "w": rng.standard_normal(
                    (layer.k, layer.k, layer.in_ch, layer.out_ch),
                    np.float32) * np.float32(0.3),
                "b": rng.standard_normal((layer.out_ch,), np.float32)
                * np.float32(0.1)})
        else:
            params.append({})
    return params


def span_inputs(specs, hw, ch, edges, span, batch=2, seed=0):
    """Both packages' nets, numpy params, every map of the torch oracle
    (as numpy) and the span's (a, b, spill, src_keys)."""
    net = chain("t", specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    j_net = j_chain("t", specs, in_h=hw, in_w=hw, in_ch=ch,
                    residual_edges=edges)
    params = numpy_params(net, seed)
    xs = np.random.default_rng(seed + 1).standard_normal(
        (batch, hw, hw, ch), np.float32)
    maps = cnn.reference_forward(convert.params_from_numpy(params),
                                 torch.from_numpy(xs), net, collect=True)
    a, b = span or (0, net.n_layers)
    cuts = [c for c in (a, b) if 0 < c < net.n_layers]
    spill = tuple(sorted({s for (s, t) in edges
                          if any(s < p < t for p in cuts) and a < s < b}))
    src_keys = tuple(sorted({s for (s, t) in edges if s < a < t <= b}))
    return net, j_net, params, [m.numpy() for m in maps], (a, b, spill,
                                                          src_keys)


def test_rowops_twins_match_reference():
    rng = np.random.default_rng(3)
    ring = rng.standard_normal((2, 5, 9, 4), np.float32)
    w = rng.standard_normal((3, 3, 4, 6), np.float32)
    b = rng.standard_normal((6,), np.float32)
    t_ring = torch.from_numpy(ring)
    for r, stride, pad, h_prev in [(0, 1, 1, 9), (3, 1, 1, 9), (4, 2, 1, 9),
                                   (8, 1, 1, 9)]:
        for pad_val in (0.0, rowops.NEG_INF):
            got = rowops.ring_window(t_ring, r, 3, stride, pad, h_prev, 5,
                                     pad_val)
            for i in range(2):
                want = j_rowops.ring_window(jnp.asarray(ring[i]), r, 3,
                                            stride, pad, h_prev, 5, pad_val)
                np.testing.assert_array_equal(got[i].numpy(),
                                              np.asarray(want))
        win = rowops.ring_window(t_ring, r, 3, stride, pad, h_prev, 5, 0.0)
        out_w = (9 + 2 * pad - 3) // stride + 1
        got = rowops.conv_row(win, torch.from_numpy(w), torch.from_numpy(b),
                              stride, pad, out_w)
        pooled = rowops.pool_row(win, 3, stride, pad, out_w)
        for i in range(2):
            j_win = jnp.asarray(win[i].numpy())
            want = j_rowops.conv_row(j_win, jnp.asarray(w), jnp.asarray(b),
                                     stride, pad, out_w)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       **TOL)
            np.testing.assert_array_equal(
                pooled[i].numpy(),
                np.asarray(j_rowops.pool_row(j_win, 3, stride, pad, out_w)))
    src = rng.standard_normal((2, 8, 4), np.float32)
    for w_t, c_t in [(4, 8), (8, 4), (8, 2), (4, 4)]:
        got = rowops.project_row(torch.from_numpy(src), w_t, c_t)
        for i in range(2):
            want = j_rowops.project_row(jnp.asarray(src[i]), w_t, c_t)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("name,specs,hw,ch,edges,span,out_rows", CASES,
                         ids=[c[0] for c in CASES])
def test_span_forward_cpu_matches_reference_kernel(name, specs, hw, ch,
                                                   edges, span, out_rows):
    """The port's span_forward on CPU tensors (the plain version) equals
    the reference kernel run in interpret mode, output and spills."""
    net, j_net, params, maps, (a, b, spill, src_keys) = span_inputs(
        specs, hw, ch, edges, span)
    got = span_forward(torch.from_numpy(maps[a]),
                       convert.params_from_numpy(params[a:b]), net, a, b,
                       out_rows=out_rows,
                       srcs={s: torch.from_numpy(maps[s]) for s in src_keys},
                       spill=spill)
    want = j_span_forward(jnp.asarray(maps[a]),
                          [{k: jnp.asarray(v) for k, v in p.items()}
                           for p in params[a:b]], j_net, a, b,
                          interpret=True, out_rows=out_rows,
                          srcs={s: jnp.asarray(maps[s]) for s in src_keys},
                          spill=spill)
    if spill:
        (got, got_sp), (want, want_sp) = got, want
        for m in spill:
            np.testing.assert_allclose(got_sp[m].numpy(),
                                       np.asarray(want_sp[m]), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=name)
    np.testing.assert_allclose(got.numpy(), maps[b], **TOL, err_msg=name)


def test_legacy_fused_span_matches_oracle_and_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 8, 4), np.float32)
    w1 = rng.standard_normal((3, 3, 4, 8), np.float32) * np.float32(0.2)
    b1 = rng.standard_normal((8,), np.float32) * np.float32(0.1)
    w2 = rng.standard_normal((3, 3, 8, 4), np.float32) * np.float32(0.2)
    b2 = rng.standard_normal((4,), np.float32) * np.float32(0.1)
    args = [torch.from_numpy(v) for v in (x, w1, b1, w2, b2)]
    got = fused_span(*args)
    np.testing.assert_allclose(got.numpy(), fused_span_ref(*args).numpy(),
                               **TOL)
    want = j_fused_span(*[jnp.asarray(v) for v in (x, w1, b1, w2, b2)],
                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        fused_span(args[0], torch.zeros(2, 2, 4, 4), args[2],
                   torch.zeros(2, 2, 4, 4), args[4])


def test_missing_crossing_source_raises():
    name, specs, hw, ch, edges, span, _ = CASES[-1]
    net, _j, params, maps, (a, b, spill, _src) = span_inputs(
        specs, hw, ch, edges, span)
    xs = torch.from_numpy(maps[a])
    tparams = convert.params_from_numpy(params[a:b])
    with pytest.raises(ValueError, match="residual sources"):
        span_forward(xs, tparams, net, a, b, spill=spill)
    with pytest.raises(ValueError, match="residual sources"):
        kernel.span_cuda_call(xs, tparams, net, a, b, spill=spill)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.span_cuda_call(xs, tparams, net, a, b, spill=spill,
                              srcs={0: torch.from_numpy(maps[0])})
    with pytest.raises(ValueError, match="bad span"):
        span_forward(xs, tparams, net, 4, 1)


@pytest.mark.parametrize("out_rows", [1, 2])
@pytest.mark.parametrize("name,specs,hw,ch,edges,span,_t", CASES,
                         ids=[c[0] for c in CASES])
def test_workspace_is_exactly_the_closure(name, specs, hw, ch, edges, span,
                                          _t, out_rows):
    """The kernel's ring workspace per image is |DC(a, b)| — the reference
    kernel's VMEM scratch — and the descriptor's ring offsets tile it."""
    net, j_net, _p, _m, (a, b, spill, src_keys) = span_inputs(
        specs, hw, ch, edges, span)
    scratch, weights = span_kernel_scratch_elems(net, a, b, out_rows)
    assert scratch == closure.span_closure_elems(net, a, b, out_rows)
    assert scratch + weights == \
        closure.span_footprint_elems(net, a, b, out_rows)
    assert (scratch, weights) == span_kernel_vmem_elems(j_net, a, b,
                                                        out_rows)
    sched = closure.span_schedule(net, a, b, spill=spill, out_rows=out_rows)
    desc = kernel._descriptor(net, a, b, sched, spill, src_keys)
    assert desc[:3] == [b - a + 1, sched.in_rows, sched.n_steps]


def _geometry_spans(name):
    """(net, [(a, b)]) of the plans whose spans the geometry must serve:
    the two ``chip_smoke.py`` runs and VGG at two capacities."""
    if name == "resnet18":
        net = zoo.resnet18()
        cuts = [0, 12, 15, 16, 17, net.n_layers]
        return net, list(zip(cuts, cuts[1:]))
    if name == "alexnet":
        plan = occam.load_plan(str(EXAMPLES / "alexnet.plan.json"))
    else:
        plan = occam.plan(zoo.vggnet(), int(name.split("-")[1]))
    return plan.net, [(r.start, r.end) for r in plan.routes]


@pytest.mark.parametrize("cluster", kernel.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["resnet18", "alexnet", "vggnet-786432",
                                  "vggnet-3145728"])
def test_launch_geometry_tiles_rows_once(name, cluster):
    """For every map of every span: the cluster's CTA tiles cover the
    row's W_out x C_out exactly once, a conv tile's register tiles and
    K-split groups fit the CTA's threads, its K-chunks fit the shared
    memory of two CTAs per SM (so within the H100's 232,448 bytes per
    block), and the
    descriptor carries the tiles. ResNet-18 at batch 8 runs on >= 128 CTAs
    with clusters of 16."""
    net, spans = _geometry_spans(name)
    if name == "resnet18":
        assert [(a, b) for a, b in spans] == [(0, 12), (12, 15), (15, 16),
                                              (16, 17), (17, 18)]
        if cluster == 16:
            assert 8 * kernel.span_geometry(net, 0, 12, cluster).cluster \
                >= 128
    for a, b in spans:
        geom = kernel.span_geometry(net, a, b, cluster)
        assert geom.cluster == cluster
        assert geom.smem + kernel.STATIC_SMEM <= 232_448
        assert geom.tiles[0] is None and len(geom.tiles) == b - a + 1
        for off, layer in enumerate(net.layers[a:b], start=1):
            t = geom.tiles[off]
            assert t.n_wt * t.n_ct <= cluster and t.tc % 4 == 0
            cover = np.zeros((layer.out_w, layer.out_ch), np.int64)
            for x0, nx, c0, nc in t.tiles(cluster, layer.out_w,
                                          layer.out_ch):
                cover[x0:x0 + nx, c0:c0 + nc] += 1
            assert (cover == 1).all(), (name, a, b, off)
            assert t.smem <= geom.smem
            if layer.kind != "conv":
                assert (t.bk, t.ks, t.smem) == (0, 0, 0)
                continue
            twp = -(-t.tw // 4) * 4
            assert twp * t.tc <= 16 * kernel.THREADS
            assert t.bk & (t.bk - 1) == 0 and 4 <= t.bk <= kernel.MAX_BK
            assert 2 <= t.stages <= kernel.MAX_STAGES
            kc = layer.k ** 2 * t.bk if t.window else t.bk
            assert 1 <= t.ks <= kc // 4
            assert t.ks * (twp // 4) * (t.tc // 4) <= kernel.THREADS
            stage = kernel._stage_bytes(twp, t.tc, layer.k, layer.stride,
                                        t.bk, t.window)
            red = t.ks * twp * t.tc * 4
            # a row's K-split sums share its last chunk's stage, or follow
            # the stages where they do not fit one
            assert t.smem == t.stages * stage + (red if red > stage else 0)
            if t.window:  # channel groups of 4, fewer values than im2col
                assert layer.in_ch % 4 == 0
                assert (twp - 1) * layer.stride + layer.k < twp * layer.k
            assert t.smem <= kernel.SMEM_BUDGET - kernel.DESC_RESERVE
        spill = span_engine.span_spills(net, [c for c in (a, b)
                                              if 0 < c < net.n_layers], a, b)
        sched = closure.span_schedule(net, a, b, spill=spill)
        desc = kernel._descriptor(net, a, b, sched, spill,
                                  kernel.crossing_source_keys(net, a, b),
                                  cluster)
        assert desc[5] == cluster
        assert kernel.launch_smem(geom, desc) + kernel.STATIC_SMEM \
            <= 232_448
        maps = desc[desc[9]:desc[9] + (b - a + 1) * kernel._M_LEN]
        for off in range(1, b - a + 1):
            t = geom.tiles[off]
            rec = maps[off * kernel._M_LEN:(off + 1) * kernel._M_LEN]
            assert rec[-7:] == [t.tw, t.tc, t.n_ct, t.bk, t.ks, t.stages,
                                int(t.window)]


def _tma_maps(name, cluster):
    """(layer, tile, descriptor stage offset) of every conv map of a
    benchmark plan (as :func:`_geometry_spans`) or of a CPU or GPU case."""
    cases = {c[0]: c for c in CASES + CUDA_CASES}
    if name in cases:
        specs, hw, ch, edges, span = cases[name][1:6]
        net = chain(name, specs, in_h=hw, in_w=hw, in_ch=ch,
                    residual_edges=edges)
        spans = [span or (0, net.n_layers)]
    else:
        net, spans = _geometry_spans(name)
    out = []
    for a, b in spans:
        cuts = [c for c in (a, b) if 0 < c < net.n_layers]
        spill = span_engine.span_spills(net, cuts, a, b)
        sched = closure.span_schedule(net, a, b, spill=spill)
        geom = kernel.span_geometry(net, a, b, cluster)
        desc = kernel._descriptor(net, a, b, sched, spill,
                                  kernel.crossing_source_keys(net, a, b),
                                  cluster)
        for off, layer in enumerate(net.layers[a:b], start=1):
            if layer.kind == "conv":
                out.append((layer, geom.tiles[off], desc[8]))
    return out


@pytest.mark.parametrize("cluster", kernel.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["resnet18", "alexnet", "vggnet-786432",
                                  "vggnet-3145728"]
                         + sorted({c[0] for c in CASES + CUDA_CASES}))
def test_tma_boxes_land_b_in_the_padded_stages(name, cluster):
    """For every conv map of the benchmark plans and of the CPU and GPU
    cases, ``cout-2-mod-4``'s C_out of 6 and 10 included: B's TMA box is
    ``tc`` channels (a 16-byte multiple) by at most 256 K rows (by k * k
    taps in window mode), and the chunk's copies (two, or two a tap, past
    256) cover B[kc][tc] exactly, the bytes its mbarrier waits for; the
    K-chunk
    region starts 128-byte aligned, each stage's A part is padded so B
    starts 128-byte aligned, and the next stage too, and the region (the
    stages, then the K-split sums where they do not fit one) fits
    ``SMEM_BUDGET - DESC_RESERVE``. The mbarriers, one for each of the
    ``MAX_STAGES`` stages a map may hold, are static shared memory beside
    the tap table and the TMA byte sum, and a CTA with all of it still
    leaves room for a second on the SM (228 KB, 1 KB reserved a CTA)."""
    for layer, t, stage_off in _tma_maps(name, cluster):
        box = kernel.tma_box(layer, t)
        kc = layer.k ** 2 * t.bk if t.window else t.bk
        assert box is not None and box[0] == t.tc and t.tc % 4 == 0
        assert max(box) <= kernel.TMA_BOX_MAX
        assert box[1] == min(t.bk, kernel.TMA_BOX_MAX)
        copies = t.bk // box[1] * (layer.k ** 2 // box[2]
                                   if t.window else 1)
        assert len(box) == (3 if t.window else 2)
        assert copies * int(np.prod(box)) == kc * t.tc
        assert copies == (1 if t.bk <= 256 else
                          2 * layer.k ** 2 if t.window else 2)
        twp = -(-t.tw // 4) * 4
        b_off, st = kernel._stage_floats(twp, t.tc, layer.k, layer.stride,
                                         t.bk, t.window)
        assert (4 * stage_off) % 128 == 0
        assert (4 * b_off) % 128 == 0 and (4 * st) % 128 == 0
        if t.window:
            a = layer.k * ((twp - 1) * layer.stride + layer.k) * (t.bk + 4)
        else:
            a = twp * (t.bk + 4)
        assert a <= b_off < a + 32 and b_off + kc * t.tc <= st
        red = t.ks * twp * t.tc
        assert 4 * (t.stages * st + (red if red > st else 0)) == t.smem
        assert t.smem <= kernel.SMEM_BUDGET - kernel.DESC_RESERVE
        assert t.stages <= kernel.MAX_STAGES
        assert kernel.STATIC_SMEM == 4 * kernel.MAX_TAPS + 8 \
            + kernel.MAX_STAGES * kernel.MBARRIER
        assert 2 * (4 * stage_off + t.smem + kernel.STATIC_SMEM + 1024) \
            <= 233_472


@pytest.mark.parametrize("cluster", kernel.CLUSTER_SIZES)
def test_a_512_deep_im2col_chunk_takes_two_boxes(cluster):
    """The GPU case ``stem-11x11-s4`` (AlexNet's 11x11 stride-4 stem at 16
    channels) stages im2col chunks 512 K rows deep (K = 363): over the
    box's 256-row edge, so a chunk is two copies, the second 256 rows on
    (past K: zero filled). The benchmark plans' convs take one box a
    chunk: their deepest chunks, the 64-channel stems', are 256 rows."""
    deep = [(layer, t) for layer, t, _s in _tma_maps("stem-11x11-s4",
                                                     cluster)
            if t.bk > 256]
    assert deep and all(not t.window for _l, t in deep)
    for layer, t in deep:
        assert kernel.tma_box(layer, t) == (t.tc, 256)
    for name in ("resnet18", "alexnet", "vggnet-3145728"):
        assert all(t.bk <= 256 for _l, t, _s in _tma_maps(name, cluster))


def test_launch_geometry_raises_outside_the_kernel():
    """No fallback: a window wider than the kernel takes, or a row no
    tiling fits, raises at geometry time."""
    with pytest.raises(ValueError, match="wider"):
        kernel.row_tile("conv", 33, 3, 8, 8, 16)
    with pytest.raises(ValueError, match="no tiling"):
        kernel.row_tile("conv", 3, 3, 4096, 512, 16)


def test_a_row_wider_than_the_boxes_of_a_cluster_raises():
    """A CTA's channels are one TMA box edge at most (256): a 4-wide row
    of 4,096 channels takes tiles of 256 in clusters of 16, and one of
    4,100 channels, which tiles of 260 would serve, raises as any row no
    tiling fits; so does a pool's."""
    assert kernel.row_tile("conv", 3, 64, 4, 4096, 16).tc == 256
    for kind in ("conv", "pool"):
        with pytest.raises(ValueError, match="no tiling"):
            kernel.row_tile(kind, 3, 64, 4, 4100, 16)
    assert kernel.tma_box(zoo.resnet18().layers[1], kernel.row_tile(
        "pool", 3, 64, 56, 64, 16)) is None


@pytest.mark.parametrize("sizes", [(4,), (), (16, 12)])
def test_cluster_sizes_pin_is_validated(monkeypatch, sizes):
    """``CLUSTER_SIZES`` may be pinned to (8,) or (16,); any other size is
    refused before the device is asked anything."""
    monkeypatch.setattr(kernel, "CLUSTER_SIZES", sizes)
    net = chain("t", [(C, 3, 1, 1, 4)], in_h=8, in_w=8, in_ch=3)
    with pytest.raises(ValueError, match="CLUSTER_SIZES"):
        kernel._span_plan(net, 0, 1, (), 1, (), torch.float32,
                          torch.device("cpu"))


def _group_replay(net, a, b, spill, out_rows):
    """Replay SPAN(a, b)'s schedule as the kernel runs it: each input
    arrival, then each (step, map) group's rows back to back, with one
    cluster barrier after the group. Asserts what makes that barrier
    enough: no row of a group reads the map the group writes, nor a ring
    slot another row of the group writes, and every row it reads is still
    in its ring. Returns the groups' sizes."""
    sched = closure.span_schedule(net, a, b, spill=spill, out_rows=out_rows)
    caps, n_maps = sched.ring_caps, b - a + 1
    table = sched.slot_table()
    ring = {}  # (map offset, slot) -> the row it holds
    sizes = []
    for t, step in enumerate(sched.steps):
        blk = sched.arrivals[t]
        if blk >= 0:
            for g in range(blk * sched.in_rows,
                           min((blk + 1) * sched.in_rows,
                               net.map_shape(a)[0])):
                ring[(0, g % caps[0])] = g
        slot = 0
        for off in range(1, n_maps):
            group = list(step[off - 1])
            # the kernel takes the group as its map's leading slots
            seg = table[t][slot:slot + sched.slots[off - 1]]
            assert seg == group + [-1] * (len(seg) - len(group))
            slot += sched.slots[off - 1]
            if not group:
                continue
            sizes.append(len(group))
            layer = net.layers[a + off - 1]
            h_in = net.map_shape(a + off - 1)[0]
            h_out = net.map_shape(a + off)[0]
            writes = {}
            for r in group:
                reads = [(off - 1, rr) for rr in
                         range(r * layer.stride - layer.padding,
                               r * layer.stride - layer.padding + layer.k)
                         if 0 <= rr < h_in]
                for src, dst in net.residual_edges:
                    if dst == a + off and src >= a:
                        h_s = net.map_shape(src)[0]
                        reads.append((src - a, min(r * max(h_s // h_out, 1),
                                                   h_s - 1)))
                for m, rr in reads:
                    assert m < off
                    assert (m, rr % caps[m]) not in writes
                    assert ring.get((m, rr % caps[m])) == rr
                if off < n_maps - 1:
                    assert (off, r % caps[off]) not in writes
                    writes[(off, r % caps[off])] = r
            ring.update(writes)
    return sizes


@pytest.mark.parametrize("out_rows", [1, 2])
@pytest.mark.parametrize("name,specs,hw,ch,edges,span,_t", CASES,
                         ids=[c[0] for c in CASES])
def test_one_barrier_per_group_is_enough(name, specs, hw, ch, edges, span,
                                         _t, out_rows):
    """Each (step, map) group of every case's schedule can run its rows
    back to back behind one cluster barrier (:func:`_group_replay`), and
    ``span_counts`` counts its rows and those barriers."""
    net, _j, _p, _m, (a, b, spill, _src) = span_inputs(specs, hw, ch,
                                                        edges, span)
    sizes = _group_replay(net, a, b, spill, out_rows)
    sched = closure.span_schedule(net, a, b, spill=spill, out_rows=out_rows)
    arrivals = sum(blk >= 0 for blk in sched.arrivals)
    assert kernel.span_counts(sched) == (sum(sizes), len(sizes) + arrivals)


@pytest.mark.parametrize("name,span,want", [
    ("resnet18", (0, 12), (532, 159)), ("resnet18", (12, 15), (35, 28)),
    ("resnet18", (15, 16), (7, 14)), ("alexnet", (0, 8), (167, 49))])
def test_span_counts_of_the_benchmark_plans(name, span, want):
    """Rows and cluster barriers an image of the benchmark plans' spans:
    a barrier per arrival and per (step, map) group, so a span of one-row
    groups keeps one a row and arrival. ResNet-18's plan goes from 630
    barriers an image (one a row and arrival) to 229, 2.57 rows a
    barrier, and AlexNet's from 175 to 49, 3.41."""
    net, spans = _geometry_spans(name)
    rows = barriers = arrivals = 0
    for a, b in spans:
        spill = span_engine.span_spills(net, [c for c in (a, b)
                                              if 0 < c < net.n_layers], a, b)
        sched = closure.span_schedule(net, a, b, spill=spill)
        n_rows, n_barriers = kernel.span_counts(sched)
        n_arrivals = sum(blk >= 0 for blk in sched.arrivals)
        if max(_group_replay(net, a, b, spill, 1)) == 1:
            assert n_barriers == n_rows + n_arrivals
        if (a, b) == span:
            assert (n_rows, n_barriers) == want
        rows, barriers = rows + n_rows, barriers + n_barriers
        arrivals += n_arrivals
    assert (rows, barriers, rows + arrivals) == {
        "resnet18": (588, 229, 630), "alexnet": (167, 49, 175)}[name]


@pytest.mark.parametrize("out_rows", [1, 2])
@pytest.mark.parametrize("cluster", kernel.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["resnet-groups-64", "wide-group"])
def test_cuda_group_cases_hold_long_and_wide_groups(name, cluster,
                                                    out_rows):
    """The GPU parity cases written for row groups have what they are for:
    ``resnet-groups-64`` a group of 8 rows or more, ``wide-group`` one
    whose rows hold more outputs of one CTA than its 16 x 256 tile."""
    _n, specs, hw, ch, edges, span = {c[0]: c for c in CUDA_CASES}[name]
    net = chain(name, specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    a, b = span or (0, net.n_layers)
    _group_replay(net, a, b, (), out_rows)
    sched = closure.span_schedule(net, a, b, out_rows=out_rows)
    geom = kernel.span_geometry(net, a, b, cluster)
    widest = max(len(step[off - 1]) * geom.tiles[off].tw * geom.tiles[off].tc
                 for step in sched.steps for off in range(1, b - a + 1))
    longest = max(len(ops) for step in sched.steps for ops in step)
    if name == "resnet-groups-64":
        assert longest >= 8
    else:
        assert widest > kernel.THREADS * 16

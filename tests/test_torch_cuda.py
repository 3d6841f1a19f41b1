"""GPU-only tests of the port: the CUDA fused-span, flash-attention and
SSD-scan kernels against their plain PyTorch versions, a deployment on the
GPU against the same deployment on the CPU, the fused-span kernel at a
pinned cluster of 8, serving sessions' CUDA graphs against eager runs,
STAP pipelines on one GPU against the single-device run, the MoE layer on
the GPU against the CPU, the LMs' (Llama, Mamba2, OLMoE and the
SeamlessM4T encoder-decoder) prefill and decode on the GPU against the
CPU, a smoke train step on the GPU against the CPU, and what runs across
mesh positions on one GPU (the LM pipeline against ``decoder_stack``,
expert-parallel MoE and the compressed all-reduce against the CPU), a
dry-run cell drawn on the GPU against its ``meta`` record, and the
quickstart example on the GPU.

This file imports neither JAX nor ``repro``, so it runs on a GPU machine
that has only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. Without a visible GPU each test skips itself.
"""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import convert, occam
from repro_torch.configs import get_smoke
from repro_torch.core import closure
from repro_torch.core.graph import chain
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain_call
from repro_torch.kernels.fused_span import kernel
from repro_torch.kernels.fused_span.ops import span_plain_call
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_cb_plain,
                                              ssd_scan_plain_call)
from repro_torch.launch.serve import generate
from repro_torch.launch.train import train
from repro_torch.launch.train_step import make_train_step
from repro_torch.models import cnn, moe
from repro_torch.models.api import build_model, make_batch
from repro_torch.occam.calibrate import timers
from repro_torch.optim.adamw import AdamW

C, P = "conv", "pool"

# (name, specs, hw, in_ch, residual edges, span)
CASES = [
    ("k1-s1", [(C, 1, 1, 0, 4), (C, 1, 1, 0, 8)], 8, 3, (), None),
    ("k5-s1", [(C, 5, 1, 2, 4), (C, 5, 1, 2, 4)], 10, 2, (), None),
    ("k3-s2", [(C, 3, 2, 1, 4), (C, 3, 1, 1, 8)], 10, 3, (), None),
    ("conv-pool-s2", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 2, 1, 8)],
     12, 3, (), None),
    ("pool-k3-s2-pad", [(C, 3, 1, 1, 4), (P, 3, 2, 1, 0)], 9, 3, (), None),
    # span (1, 4): (0, 2) crosses in from memory, (1, 4) adds from ring 0,
    # (2, 5) leaves the span so map 2 spills; stride-2 option-A shortcut
    ("res-src-spill", [(C, 3, 1, 1, 4)] * 3 + [(C, 3, 2, 1, 8),
                                                (C, 3, 1, 1, 8)],
     10, 3, ((0, 2), (1, 4), (2, 5)), (1, 4)),
    # the cluster's split: a 30-wide row whose tiles give all 16 CTAs
    # work, W_out and C_out not multiples of the tile
    ("wide-40-72", [(C, 3, 1, 1, 72), (P, 2, 2, 0, 0)], 30, 40, (), None),
    # K = 3 * 3 * 96 = 864, over three staging chunks of 256
    ("deep-k-96", [(C, 3, 1, 1, 96), (C, 3, 1, 1, 24)], 8, 3, (), None),
    # ResNet's stem, 7x7 stride 2 pad 3 on 3 channels, and AlexNet's,
    # 11x11 stride 4
    ("stem-7x7-s2", [(C, 7, 2, 3, 16), (P, 3, 2, 1, 0)], 32, 3, (), None),
    ("stem-11x11-s4", [(C, 11, 4, 0, 16), (P, 3, 2, 0, 0)], 39, 3, (),
     None),
    # stride-2 option-A shortcut padding channels 8 -> 16 (ResNet's
    # 64 -> 128 ratio at small width), from a ring and from memory
    ("opt-a-ring", [(C, 3, 1, 1, 8), (C, 3, 2, 1, 16), (C, 3, 1, 1, 16)],
     12, 3, ((1, 3),), None),
    ("opt-a-memory", [(C, 3, 1, 1, 8), (C, 3, 2, 1, 16), (C, 3, 1, 1, 16)],
     12, 3, ((1, 3),), (2, 3)),
    # ResNet's stem, pool and three 3x3 convs at 64x64 with a shortcut:
    # the stem's (step, map) groups hold 8 rows (10 at out_rows 2)
    ("resnet-groups-64", [(C, 7, 2, 3, 16), (P, 3, 2, 1, 0),
                          (C, 3, 1, 1, 16), (C, 3, 1, 1, 16),
                          (C, 3, 1, 1, 16)], 64, 3, ((2, 4),), None),
    # a group of 8 (16) rows of a 64 x 256 map: 8,192 or more outputs a
    # CTA, wider than its 16 x 256 tile, and K-split sums too large for a
    # K-chunk's stage
    ("wide-group", [(C, 3, 1, 1, 256)] + [(C, 3, 2, 1, 16)] * 3, 64, 4, (),
     None),
    # VGG-19's first block: 224-wide rows of 64 channels (14,336 outputs a
    # row), ending in a 2x2 stride-2 pool
    ("vgg-224-64-pool", [(C, 3, 1, 1, 64), (C, 3, 1, 1, 64),
                         (P, 2, 2, 0, 0)], 224, 3, (), None),
    # one of VGG-19's 512 -> 512 convs on a 28-row map: K = 4,608
    ("vgg-k4608-28", [(C, 3, 1, 1, 512)], 28, 512, (), None),
    # C_out 6 and 10 (2 mod 4): weights padded per launch to rows of 8 and
    # 12 channels, which TMA takes, the map's extent still C_out, in window
    # and in im2col mode
    ("cout-2-mod-4", [(C, 3, 1, 1, 6), (C, 3, 1, 1, 10)], 10, 4, (), None),
    # partial K-chunks and channel tiles under TMA: im2col K = 54 in a chunk
    # of 64, C_in 44 in window chunks of 64 (32 at clusters of 8, a tail of
    # 12), C_out 44 and 52 in tiles of 12 and 8 (28)
    ("ragged-k-c", [(C, 3, 1, 1, 44), (C, 3, 1, 1, 52)], 14, 6, (), None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def numpy_params(net, rng):
    params = []
    for layer in net.layers:
        if layer.kind == "conv":
            fan_in = layer.k * layer.k * layer.in_ch
            params.append({
                "w": (rng.standard_normal(
                    (layer.k, layer.k, layer.in_ch, layer.out_ch),
                    np.float32) * np.sqrt(2.0 / fan_in)).astype(np.float32),
                "b": rng.standard_normal((layer.out_ch,), np.float32)
                * np.float32(0.1)})
        else:
            params.append({})
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,specs,hw,ch,edges,span", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_version(cuda, dtype, name, specs, hw, ch,
                                           edges, span):
    """The CUDA kernel equals its plain version on the card (fp32 1e-4
    with TF32 off; bf16 5e-2), output and spills, at out_rows 1 and 2, and
    each call is one counted launch that adds its schedule's rows and
    cluster barriers, and whose CTAs sum on the device the bytes the host
    counts them to stage by TMA, batch x ``weight_bytes``."""
    rng = np.random.default_rng(0)
    net = chain(name, specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    params = [{k: v.to(dtype) for k, v in p.items()} for p in
              convert.params_from_numpy(numpy_params(net, rng), cuda)]
    xs = torch.from_numpy(rng.standard_normal((2, hw, hw, ch),
                                              np.float32)).to(cuda, dtype)
    maps = cnn.reference_forward(params, xs, net, collect=True)
    a, b = span or (0, net.n_layers)
    cuts = [c for c in (a, b) if 0 < c < net.n_layers]
    spill = tuple(sorted({s for (s, t) in edges
                          if any(s < p < t for p in cuts) and a < s < b}))
    srcs = {s: maps[s] for (s, t) in edges if s < a < t <= b}
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for out_rows in (1, 2):
        before = kernel.counts.copy()
        tally = kernel.tma_tally(cuda)
        got, got_sp = kernel.span_cuda_call(maps[a], params[a:b], net, a, b,
                                            out_rows=out_rows, srcs=srcs,
                                            spill=spill)
        assert kernel.tma_tally(cuda) - tally == 2 * kernel.last_launch[
            "weight_bytes"]
        sched = closure.span_schedule(net, a, b, spill=spill,
                                      out_rows=out_rows)
        n_rows, n_barriers = kernel.span_counts(sched)
        cost = kernel.launch_counts(
            net, a, b, sched, kernel.span_geometry(
                net, a, b, kernel.last_launch["cluster"]))
        assert (cost.launches, cost.rows, cost.barriers) == (1, n_rows,
                                                             n_barriers)
        assert kernel.counts - before == cost
        assert {k: kernel.last_launch[k] for k in (
            "rows", "barriers", "weight_bytes")} == {
            "rows": n_rows, "barriers": n_barriers,
            "weight_bytes": cost.weight_bytes}
        want, want_sp = span_plain_call(maps[a], params[a:b], net, a, b,
                                        out_rows=out_rows, srcs=srcs,
                                        spill=spill)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert set(got_sp) == set(spill)
        for m in spill:
            torch.testing.assert_close(got_sp[m].float(), want_sp[m].float(),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
def test_deployment_on_gpu_matches_cpu(cuda):
    """``compile()`` defaults to the GPU; its kernel-routed run equals the
    CPU deployment's plain-version run, with the same traffic counts."""
    net = chain("res", [(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4),
                        (C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)],
                in_h=16, in_w=16, in_ch=3, residual_edges=((2, 4), (4, 6)))
    rng = np.random.default_rng(1)
    params = numpy_params(net, rng)
    xs = rng.standard_normal((3, 16, 16, 3), np.float32)
    plan = occam.plan(net, 700)
    gpu = plan.place().compile()
    cpu = plan.place().compile(device="cpu")
    assert gpu.device.type == "cuda"
    before = kernel.counts.launches
    got = gpu.run(params, xs)
    kernel_spans = sum(r.route == "pallas" for r in gpu.routes)
    assert kernel_spans > 0
    assert kernel.counts.launches == before + kernel_spans
    want = cpu.run(params, xs)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert gpu.report().matches_prediction
    assert gpu.counter.total == cpu.counter.total


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,specs,hw,ch,edges,span", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_at_cluster_8(cuda, monkeypatch, dtype,
                                                name, specs, hw, ch, edges,
                                                span):
    """With ``CLUSTER_SIZES`` pinned to 8, every span launches clusters of
    8 CTAs (the geometry the H100 otherwise never takes, as it places
    16) and still equals its plain version (fp32 1e-4, bf16 5e-2)."""
    monkeypatch.setattr(kernel, "CLUSTER_SIZES", (8,))
    rng = np.random.default_rng(0)
    net = chain(name, specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    params = [{k: v.to(dtype) for k, v in p.items()} for p in
              convert.params_from_numpy(numpy_params(net, rng), cuda)]
    xs = torch.from_numpy(rng.standard_normal((2, hw, hw, ch),
                                              np.float32)).to(cuda, dtype)
    maps = cnn.reference_forward(params, xs, net, collect=True)
    a, b = span or (0, net.n_layers)
    cuts = [c for c in (a, b) if 0 < c < net.n_layers]
    spill = tuple(sorted({s for (s, t) in edges
                          if any(s < p < t for p in cuts) and a < s < b}))
    srcs = {s: maps[s] for (s, t) in edges if s < a < t <= b}
    for out_rows in (1, 2):
        tally = kernel.tma_tally(cuda)
        got, got_sp = kernel.span_cuda_call(maps[a], params[a:b], net, a, b,
                                            out_rows=out_rows, srcs=srcs,
                                            spill=spill)
        assert kernel.last_launch["cluster"] == 8
        assert kernel.last_launch["ctas"] == 2 * 8
        assert kernel.tma_tally(cuda) - tally == 2 * kernel.last_launch[
            "weight_bytes"]
        want, want_sp = span_plain_call(maps[a], params[a:b], net, a, b,
                                        out_rows=out_rows, srcs=srcs,
                                        spill=spill)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        for m in spill:
            torch.testing.assert_close(got_sp[m].float(), want_sp[m].float(),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "int8", "bf16"])
def test_session_on_gpu_equals_run(cuda, policy):
    """A serving session on the card replays one captured CUDA graph per
    round size: its lanes equal the eager ``run`` of the same images bit
    for bit, one capture serves every submit size, and each replay adds
    the captured launches, rows, barriers and weight bytes to the kernel's
    counts. The device's sum of the bytes staged by TMA grows by the
    round's lanes times ``per_replay``'s weight bytes each replay, as it
    does each eager launch."""
    net = chain("res", [(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4),
                        (C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)],
                in_h=16, in_w=16, in_ch=3, residual_edges=((2, 4), (4, 6)))
    rng = np.random.default_rng(2)
    params = numpy_params(net, rng)
    dep = occam.plan(net, 700, dtype_policy=policy).place().compile()
    spans = sum(r.route == "pallas" for r in dep.routes)
    assert spans > 0
    sizes = [4, 1, 5, 3]
    xs = [rng.standard_normal((n, 16, 16, 3), np.float32) for n in sizes]
    # an eager run's counts, which a replay must add as well
    before = kernel.counts.copy()
    tally = kernel.tma_tally(cuda)
    dep.run(params, xs[0])
    eager = kernel.counts - before
    assert eager.launches == spans and eager.barriers > 0
    assert eager.weight_bytes > 0
    assert kernel.tma_tally(cuda) - tally == 4 * eager.weight_bytes
    before = kernel.counts.copy()
    tally = kernel.tma_tally(cuda)
    sess = dep.serve(params, round_batch=4)
    # the warm-up call
    assert kernel.counts - before == eager
    step = sess._step
    assert step.per_replay == eager
    for x in xs:
        sess.submit(x)
    res = sess.results()
    rounds = -(-sum(sizes) // 4)
    assert kernel.counts - before == kernel.Counts(
        *(v * (1 + rounds) for v in dataclasses.astuple(eager)))
    assert kernel.tma_tally(cuda) - tally \
        == 4 * (1 + rounds) * step.per_replay.weight_bytes
    assert sess.compile_count == 1
    for (_t, y), x in zip(res, xs):
        assert y.device.type == "cuda"
        assert torch.equal(y, dep.run(params, x))
    rep = sess.report()
    assert rep.images == sum(sizes)
    assert rep.matches_prediction and rep.matches_prediction_bytes


def _engine_mix(engine, xs, tenants=3):
    """Submit ``xs`` to ``engine`` from ``tenants`` tenants in turn, under
    one ``asyncio.run`` with a time limit; the tickets' outputs and the
    engine's description."""
    import asyncio

    async def drive():
        async with engine:
            tickets = [await engine.submit(x, tenant=f"t{i % tenants}")
                       for i, x in enumerate(xs)]
            outs = await asyncio.gather(*tickets)
            return outs, engine.describe()

    return asyncio.run(asyncio.wait_for(drive(), 300))


@pytest.mark.cuda
def test_frontier_serve_on_gpu_equals_run(cuda):
    """``Frontier.serve`` on ``cuda:0`` under a mixed multi-tenant load:
    every ticket's output equals ``Deployment.run`` of the same images
    bit for bit, the engine's ``compile_count`` equals a bare session's
    on the same mix (both 1: one CUDA graph), and the kernel launches
    once per span per dispatched round (plus the capture's warm-up)."""
    net = chain("res", [(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4),
                        (C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)],
                in_h=16, in_w=16, in_ch=3, residual_edges=((2, 4), (4, 6)))
    rng = np.random.default_rng(4)
    params = numpy_params(net, rng)
    frontier = occam.autoplan(net, occam.Fleet(chips=1, vmem_elems=700))
    sizes = [4, 1, 5, 3, 4, 2]
    xs = [rng.standard_normal((n, 16, 16, 3), np.float32) for n in sizes]
    before = kernel.counts.launches
    eng = frontier.serve(params, device="cuda:0", round_batch=4,
                         max_wait_ms=2.0, metrics_window_ms=600_000.0,
                         audit="error")
    dep = eng.deployment
    spans = sum(r.route == "pallas" for r in dep.routes)
    assert spans > 0 and dep.device == torch.device("cuda", 0)
    outs, desc = _engine_mix(eng, xs)
    torch.cuda.synchronize()
    rounds = desc["metrics"]["total_rounds"]
    assert rounds == desc["session"]["rounds_served"] >= -(-sum(sizes) // 4)
    assert kernel.counts.launches - before == spans * (1 + rounds)
    for y, x in zip(outs, xs):
        assert y.device == torch.device("cuda", 0)
        assert torch.equal(y, dep.run(params, x))
    sess = dep.serve(params, round_batch=4)
    for x in xs:
        sess.submit(x)
    sess.results()
    assert desc["compile_count"] == sess.compile_count == 1
    assert sess.report().matches_prediction


@pytest.mark.cuda
def test_async_engine_on_a_gpu_ring_session(cuda):
    """The async engine over a STAP ring session with every mesh position
    on ``cuda:0``: each ticket equals a bare ring session's lanes for the
    same images bit for bit (and the single-device ``run`` within fp32
    1e-4), with the bare session's one tick build."""
    net, capacity, _rect, packed = PIPE_NETS["vgg_mini"]
    rng = np.random.default_rng(5)
    params = numpy_params(net, rng)
    plan = occam.plan(net, capacity)
    dep = plan.place(replicas=packed, microbatch=2,
                     packing="sum").compile(device="cuda:0")
    sizes = [3, 12, 1, 7]
    xs = [rng.standard_normal((n,) + net.map_shape(0), np.float32)
          for n in sizes]
    outs, desc = _engine_mix(occam.AsyncEngine(dep, params,
                                               max_wait_ms=2.0), xs)
    sess = dep.serve(params)
    bare = []
    for x in xs:
        sess.submit(x)
        bare += [v for _t, v in sess.results()]
    assert desc["compile_count"] == sess.compile_count == 1
    want = plan.place().compile().run(params, np.concatenate(xs))
    for y, b in zip(outs, bare):
        assert y.device == torch.device("cuda", 0)
        assert torch.equal(y, b)
    torch.testing.assert_close(torch.cat(outs), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_capture_holds_the_garbage_collector_off(cuda, monkeypatch):
    """A deployment and its captured step form a reference cycle, so a
    dropped deployment's graph is freed by the cyclic garbage collector,
    whenever it runs; freed inside another capture, it invalidates that
    capture. So the step collects first and holds the collector off for
    the capture, and turns it back on after."""
    import gc

    states = []

    class Recording(torch.cuda.CUDAGraph):
        def capture_begin(self, *args, **kwargs):
            states.append(gc.isenabled())
            return super().capture_begin(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Recording)
    net = chain("two", [(C, 3, 1, 1, 4), (C, 3, 2, 1, 8)], in_h=8, in_w=8,
                in_ch=3)
    params = numpy_params(net, np.random.default_rng(4))
    xs = np.random.default_rng(5).standard_normal((2, 8, 8, 3), np.float32)
    dep = occam.plan(net, 700).place().compile()
    assert gc.isenabled()
    with dep.serve(params, round_batch=2) as sess:
        sess.submit(xs)
        (_t, y), = sess.results()
    assert states == [False] and gc.isenabled()
    assert torch.equal(y, dep.run(params, xs))


FLASH_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal): the reference's grid, slow cases
    # included, and one Sq > Skv causal case for the clamped offset
    (2, 4, 2, 64, 64, 32, True),
    (1, 4, 4, 48, 48, 16, False),
    (2, 8, 2, 32, 96, 64, True),
    (1, 2, 1, 1, 128, 32, False),
    (1, 2, 1, 1, 100, 32, True),
    (2, 4, 4, 80, 80, 64, True),
    (1, 16, 2, 64, 64, 128, True),
    (1, 4, 2, 48, 32, 16, True),
    # the kernel's two-stage K/V ring wrapped several times, ending on a
    # ragged tile (d = 64 and d = 128); an Sq that is not a multiple of a
    # warp's 16 rows
    (1, 8, 2, 300, 300, 64, True),
    (1, 4, 1, 130, 257, 128, False),
    (2, 4, 2, 37, 37, 32, True),
]


def flash_inputs(case, dev, dtype=torch.float32, seed=0):
    b, hq, hkv, sq, sk, d, _ = case
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


# (net, capacity, replicas for the rect and the sum-packed pipeline)
PIPE_NETS = {
    "vgg_mini": (chain("vgg_mini", [
        (C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
        (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)],
        in_h=16, in_w=16, in_ch=3), 6000, (2, 1, 1), (3, 2, 1)),
    # the cut at 5 splits the residual edge (4, 6): map 4 rides the
    # payload across it
    "res": (chain("res", [(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4),
                          (C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)],
                  in_h=16, in_w=16, in_ch=3,
                  residual_edges=((2, 4), (4, 6))),
            700, (2, 1, 1, 1), (3, 2, 1, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["rect", "sum"])
@pytest.mark.parametrize("name", sorted(PIPE_NETS))
def test_pipeline_on_one_gpu_equals_single_run(cuda, name, packing):
    """A STAP pipeline with every mesh position on ``cuda:0`` equals the
    single-device ``run`` of the same images within fp32 1e-4: ``run``
    through the rectangular mesh, a ring session through the sum-packed
    one. Every kernel-routed stage launches the kernel once per live
    slot it owns: stages x microbatches for ``run``."""
    net, capacity, rect, packed = PIPE_NETS[name]
    rng = np.random.default_rng(3)
    params = numpy_params(net, rng)
    xs = rng.standard_normal((8,) + net.map_shape(0), np.float32)
    plan = occam.plan(net, capacity)
    want = plan.place().compile().run(params, xs)
    stages = sum(r.route == "pallas" for r in plan.routes)
    assert stages == plan.n_spans
    dep = plan.place(replicas=rect if packing == "rect" else packed,
                     microbatch=2, packing=packing).compile(device="cuda:0")
    assert {d.type for d in dep.mesh.flat} == {"cuda"}
    before = kernel.counts.launches
    if packing == "rect":
        y = dep.run(params, xs)
        torch.cuda.synchronize()
        assert kernel.counts.launches - before == stages * 4
        assert dep.report().matches_prediction
    else:
        sess = dep.serve(params)
        sess.submit(xs[:3])
        sess.submit(xs[3:])
        y = torch.cat([v for _t, v in sess.results()])
        torch.cuda.synchronize()
        assert sess.compile_count == 1
        assert sess.report().matches_prediction
        # one round of 12 slots of 2: 4 live slots at every stage
        assert sess.round_batch == 12
        assert kernel.counts.launches - before == stages * 4
    assert y.device == torch.device("cuda", 0)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_pipeline_mesh_mixing_cpu_and_cuda_raises(cuda):
    net, capacity, rect, _packed = PIPE_NETS["vgg_mini"]
    placement = occam.plan(net, capacity).place(replicas=rect)
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        placement.compile(devices=["cuda:0", "cpu"] * 3)
    assert placement.compile(devices=["cuda:0"] * 6).device.type == "cuda"


@pytest.mark.cuda
def test_pipeline_hop_is_timed_on_the_device(cuda):
    """``measure_hop_seconds`` on a ``cuda:0`` mesh times the tick's own
    hop (``stap_pipeline._hop``) with the device ahead of the host: a
    positive time, below the host-clock time of the same hops issued one
    after another and synchronized (which holds the host's issue)."""
    from repro_torch.runtime import stap_pipeline as sp

    net, capacity, _rect, packed = PIPE_NETS["vgg_mini"]
    ring = occam.plan(net, capacity).place(
        replicas=packed, microbatch=2, packing="sum").compile(
        device="cuda:0").ring(2)
    hop = timers.measure_hop_seconds(ring, iters=16)
    perm = ring.assignment.slot_perm(ring.steady, 0)
    devs = ring.mesh.flat
    shape = (1, 2, ring.payload_width)
    x = [torch.zeros(shape, device=d) for d in devs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        x = sp._hop([[v[0]] for v in x], [perm], devs, shape, torch.float32)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 16
    assert 0 < hop < host


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_f32(cuda, case):
    """fp32 within the reference test's 2e-5 band; one counted launch."""
    q, k, v = flash_inputs(case, cuda)
    before = flash_kernel.launches
    got = flash_kernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
    assert flash_kernel.launches == before + 1
    want = flash_attention_plain_call(q, k, v, causal=case[-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [(1, 4, 2, 64, 64, 64, True),
                                  (1, 2, 1, 1, 96, 32, False)])
def test_flash_kernel_matches_plain_half(cuda, case, dtype):
    q, k, v = flash_inputs(case, cuda, dtype, seed=7)
    got = flash_kernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
    assert got.dtype == dtype
    want = flash_attention_plain_call(q, k, v, causal=case[-1])
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_reads_strided_views_and_valid_lengths(cuda, causal):
    """(B, S, H, D) activations go in as transposed views, without a copy;
    kv rows past seq_k_valid are masked and the causal offset comes from
    the valid lengths."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 70, 8, 64), generator=g).to(cuda).transpose(1, 2)
    k = torch.randn((2, 130, 2, 64), generator=g).to(cuda).transpose(1, 2)
    v = torch.randn((2, 130, 2, 64), generator=g).to(cuda).transpose(1, 2)
    kw = dict(causal=causal, seq_q_valid=60, seq_k_valid=111)
    got = flash_kernel.flash_attention_cuda_call(q, k, v, **kw)
    assert got.stride() == q.stride()
    want = flash_attention_plain_call(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_copies_unaligned_rows(cuda, dtype):
    """k and v starting one element into their storage: fp32 rows take the
    kernel's 4-byte copies, 16-bit rows (not even 4-byte aligned) go to an
    aligned copy first, which takes 16-byte copies; the same results
    within each dtype's band."""
    case = (1, 4, 2, 100, 100, 64, True)
    q, k, v = flash_inputs(case, cuda, dtype, seed=5)
    k1, v1 = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
              for t in (k, v))
    assert k1.data_ptr() % 16 != 0
    got = flash_kernel.flash_attention_cuda_call(q, k1, v1, causal=True)
    assert flash_kernel.last_launch["copies16"] == (dtype != torch.float32)
    want = flash_attention_plain_call(q, k, v, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_four_ctas_per_sm_at_full_width(cuda):
    """Llama-3.2-1B's prefill shape, q (4, 32, 1024, 64) against k/v
    (4, 8, 1024, 64), fp32: one CTA per (batch, head, 64 query rows), the
    shared memory of ``smem_bytes``, 16-byte copies, and the four CTAs on
    an SM that the kernel's launch bounds ask for."""
    q, k, v = flash_inputs((4, 32, 8, 1024, 1024, 64, True), cuda)
    o = flash_kernel.flash_attention_cuda_call(q, k, v, causal=True)
    torch.cuda.synchronize()
    shape = flash_kernel.last_launch
    assert shape["ctas"] == 4 * 32 * 16 and shape["threads"] == 128
    assert shape["smem"] == flash_kernel.smem_bytes(64, 4)
    assert shape["ctas_per_sm"] >= 4 and shape["copies16"]
    assert bool(torch.isfinite(o).all())


@pytest.mark.cuda
def test_llama_smoke_serving_on_gpu_matches_cpu(cuda):
    """The same parameters on both devices: GPU prefill (one kernel launch
    per layer) and decode logits match the CPU's plain-version path, and
    greedy generation emits the same tokens."""
    cfg = get_smoke("llama3.2-1b")
    cpu_api = build_model(cfg, dtype=torch.float32, device="cpu")
    gpu_api = build_model(cfg, dtype=torch.float32)
    assert gpu_api.device.type == "cuda"
    params = cpu_api.init(torch.Generator().manual_seed(0))
    gpu_params = copy.deepcopy(params).to(cuda)
    prompt = make_batch(cfg, 2, 40, generator=torch.Generator().manual_seed(1))
    prompt.pop("labels")
    before = flash_kernel.launches
    got, got_caches = gpu_api.prefill(gpu_params, prompt, 48)
    assert flash_kernel.launches == before + cfg.n_layers
    want, want_caches = cpu_api.prefill(params, prompt, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    tok = want[:, -1].argmax(-1)[:, None]
    got, _ = gpu_api.decode_step(gpu_params, tok, got_caches, 40)
    want, _ = cpu_api.decode_step(params, tok, want_caches, 40)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out_gpu = generate(gpu_api, gpu_params, prompt, 8)
    out_cpu = generate(cpu_api, params, prompt, 8)
    assert torch.equal(out_gpu["tokens"].cpu(), out_cpu["tokens"])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["local", "gspmd_scatter"])
def test_moe_sublayer_on_gpu_matches_cpu(cuda, impl):
    """The same routing on both devices (indices and positions exactly,
    drops included at the default capacity factor), and the layer's
    output and aux losses within 1e-5 in fp32 (CUDA's ``index_add_``
    accumulates in atomic order)."""
    cfg = get_smoke("olmoe-1b-7b")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                     torch.float32)
    gp = {name: v.detach().to(cuda) for name, v in p.items()}
    x = torch.randn((4, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    with torch.no_grad():
        _, idx, pos, _ = moe._route(x.reshape(-1, cfg.d_model), p["router"],
                                    e, k)
        _, g_idx, g_pos, _ = moe._route(x.to(cuda).reshape(-1, cfg.d_model),
                                        gp["router"], e, k)
        want, want_aux = moe.moe_sublayer(p, x, cfg.moe, impl=impl)
        got, got_aux = moe.moe_sublayer(gp, x.to(cuda), cfg.moe, impl=impl)
    assert torch.equal(g_idx.cpu(), idx) and torch.equal(g_pos.cpu(), pos)
    # the whole batch as one group drops an assignment (per sequence more)
    assert int((pos >= moe.capacity(x.shape[0] * x.shape[1], e, k,
                                    cfg.moe.capacity_factor)).sum()) > 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for name in want_aux:
        torch.testing.assert_close(got_aux[name].cpu(), want_aux[name],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches", [("olmoe-1b-7b", 2),
                                           ("seamless-m4t-large-v2", 6)])
def test_moe_and_encdec_smoke_serving_on_gpu_matches_cpu(cuda, arch,
                                                         launches):
    """The same parameters on both devices: GPU prefill (flash launches:
    one per attention layer, and for the encoder-decoder 2 encoder + 2
    decoder self-attention + 2 cross-attention; none in decode) and decode
    logits match the CPU's plain-version path, and greedy generation emits
    the same tokens."""
    cfg = get_smoke(arch)
    cpu_api = build_model(cfg, dtype=torch.float32, device="cpu")
    gpu_api = build_model(cfg, dtype=torch.float32)
    assert gpu_api.device.type == "cuda"
    params = cpu_api.init(torch.Generator().manual_seed(0))
    gpu_params = copy.deepcopy(params).to(cuda)
    prompt = make_batch(cfg, 2, 40, generator=torch.Generator().manual_seed(1))
    prompt.pop("labels")
    before = flash_kernel.launches
    got, got_caches = gpu_api.prefill(gpu_params, prompt, 48)
    assert flash_kernel.launches == before + launches
    want, want_caches = cpu_api.prefill(params, prompt, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    tok = want[:, -1].argmax(-1)[:, None]
    got, _ = gpu_api.decode_step(gpu_params, tok, got_caches, 40)
    want, _ = cpu_api.decode_step(params, tok, want_caches, 40)
    assert flash_kernel.launches == before + launches
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out_gpu = generate(gpu_api, gpu_params, prompt, 8)
    assert flash_kernel.launches == before + 2 * launches
    out_cpu = generate(cpu_api, params, prompt, 8)
    assert torch.equal(out_gpu["tokens"].cpu(), out_cpu["tokens"])


SSD_CASES = [
    # (B, T, H, G, P, N, chunk): the reference's grid, slow cases included
    (2, 128, 4, 1, 16, 8, 32),
    (1, 100, 4, 2, 32, 16, 32),
    (1, 64, 2, 2, 8, 4, 64),
    (1, 256, 8, 1, 64, 128, 64),
    (2, 96, 4, 4, 16, 16, 16),
]


def ssd_inputs(case, dev, dtype=torch.float32, seed=0):
    """x, a = -softplus(normal), b, c as the reference's test makes them."""
    bsz, t, h, g, p, n, _ = case
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((bsz, t, h, p), generator=gen)
    a = -torch.nn.functional.softplus(torch.randn((bsz, t, h), generator=gen))
    b = torch.randn((bsz, t, g, n), generator=gen) * 0.5
    c = torch.randn((bsz, t, g, n), generator=gen) * 0.5
    return [v.to(dev, dtype) for v in (x, a, b, c)]


def close_scaled(got, want, atol):
    """max|got - want| <= atol * max(max|want|, 1), the reference's band."""
    scale = max(float(want.float().abs().max()), 1.0)
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_kernel_matches_plain_f32(cuda, case):
    """fp32 within the reference test's 2e-5 band (scaled by
    max(|plain|, 1)); the kernel's own chunk (64) against the case's
    chunk in the plain version; one counted launch."""
    x, a, b, c = ssd_inputs(case, cuda)
    before = ssd_kernel.launches
    got, state = ssd_kernel.ssd_scan_cuda_call(x, a, b, c)
    assert ssd_kernel.launches == before + 1 and state is None
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=case[-1])
    torch.cuda.synchronize()
    close_scaled(got, want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_chunk_cb_kernel_matches_plain(cuda, case):
    """The scan's first kernel on its own: every chunk's C Bᵀ, once per
    (batch, group), against ``ssd_chunk_cb_plain`` at the kernel's chunk,
    zero rows and columns past a ragged T included."""
    _, _, b, c = ssd_inputs(case, cuda)
    before = ssd_kernel.cb_launches
    got = ssd_kernel.ssd_chunk_cb_cuda_call(b, c)
    assert ssd_kernel.cb_launches == before + 1
    want = ssd_chunk_cb_plain(b, c, chunk=ssd_kernel.CHUNK)
    assert got.shape == want.shape == (case[0], case[3],
                                       -(-case[1] // ssd_kernel.CHUNK),
                                       ssd_kernel.CHUNK, ssd_kernel.CHUNK)
    close_scaled(got, want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(6, 0), (16, 1)])
def test_ssd_kernel_stages_unaligned_fp32_rows(cuda, n, offset):
    """fp32 rows that 16-byte copies cannot take (N not a multiple of 4, or
    B, C and x starting one element into their storage) go through
    registers, with the same results within the fp32 band."""
    case = (2, 100, 4, 2, 16, n, 32)
    x, a, b, c = ssd_inputs(case, cuda, seed=7)
    if offset:
        x, b, c = (torch.cat([v.new_zeros(v.shape[:-1] + (offset,)), v], -1)
                   [..., offset:] for v in (x, b, c))
    got, _ = ssd_kernel.ssd_scan_cuda_call(x, a, b, c)
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=32)
    close_scaled(got, want, 2e-5)
    close_scaled(ssd_kernel.ssd_chunk_cb_cuda_call(b, c),
                 ssd_chunk_cb_plain(b, c, chunk=ssd_kernel.CHUNK), 2e-5)


@pytest.mark.cuda
def test_ssd_kernel_matches_plain_bf16(cuda):
    """The reference's bf16 case: y in bf16, math in fp32, within 5e-2."""
    case = (1, 128, 4, 1, 16, 16, 32)
    x, a, b, c = ssd_inputs(case, cuda, torch.bfloat16)
    got, _ = ssd_kernel.ssd_scan_cuda_call(x, a, b, c)
    assert got.dtype == torch.bfloat16
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=32)
    close_scaled(got, want, 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 200])
def test_ssd_kernel_state_in_and_out(cuda, t):
    """A nonzero state in, the state after the last (ragged) token out,
    and strided (B, T, H, P) views read in place."""
    case = (2, t, 4, 2, 32, 16, 32)
    x, a, b, c = ssd_inputs(case, cuda, seed=3)
    x = x.transpose(1, 2).contiguous().transpose(1, 2)  # strided view
    gen = torch.Generator().manual_seed(4)
    s0 = torch.randn((2, 4, 16, 32), generator=gen).to(cuda)
    got, got_s = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                               return_state=True)
    want, want_s = ssd_scan_plain_call(x, a, b, c, chunk=32, state0=s0,
                                       return_state=True)
    close_scaled(got, want, 2e-5)
    close_scaled(got_s, want_s, 2e-5)


@pytest.mark.cuda
def test_mamba_smoke_serving_on_gpu_matches_cpu(cuda):
    """The same parameters on both devices: GPU prefill (one SSD-kernel
    launch per layer, none in decode) matches the CPU's plain-version
    prefill in logits and every layer's state, decode logits match, and
    greedy generation emits the same tokens."""
    cfg = get_smoke("mamba2-1.3b")
    cpu_api = build_model(cfg, dtype=torch.float32, device="cpu")
    gpu_api = build_model(cfg, dtype=torch.float32)
    assert gpu_api.device.type == "cuda"
    params = cpu_api.init(torch.Generator().manual_seed(0))
    gpu_params = copy.deepcopy(params).to(cuda)
    prompt = make_batch(cfg, 2, 40, generator=torch.Generator().manual_seed(1))
    prompt.pop("labels")
    before = ssd_kernel.launches
    got, got_caches = gpu_api.prefill(gpu_params, prompt, 48)
    assert ssd_kernel.launches == before + cfg.n_layers
    want, want_caches = cpu_api.prefill(params, prompt, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for g, w in zip(got_caches, want_caches):
        torch.testing.assert_close(g.state.cpu(), w.state, rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(g.conv.cpu(), w.conv, rtol=1e-4,
                                   atol=1e-4)
    tok = want[:, -1].argmax(-1)[:, None]
    got, _ = gpu_api.decode_step(gpu_params, tok, got_caches, 40)
    want, _ = cpu_api.decode_step(params, tok, want_caches, 40)
    assert ssd_kernel.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out_gpu = generate(gpu_api, gpu_params, prompt, 8)
    out_cpu = generate(cpu_api, params, prompt, 8)
    assert torch.equal(out_gpu["tokens"].cpu(), out_cpu["tokens"])


@pytest.mark.cuda
def test_ssd_kernel_empty_sequence_launches_nothing(cuda):
    """T = 0: no launch; the state out is the state in (or zeros)."""
    x, a, b, c = ssd_inputs((2, 0, 4, 2, 8, 4, 16), cuda)
    s0 = torch.randn((2, 4, 4, 8), generator=torch.Generator().manual_seed(5)
                     ).to(cuda)
    before = ssd_kernel.launches
    y, state = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                             return_state=True)
    _, zeros = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, return_state=True)
    assert ssd_kernel.launches == before
    assert y.shape == (2, 0, 4, 8)
    assert torch.equal(state, s0) and not bool(zeros.any())


@pytest.mark.cuda
def test_ssd_kernel_two_ctas_per_sm_at_full_width(cuda):
    """Mamba2-1.3B's prefill shape, x (4, 1024, 64, 64) against b/c
    (4, 1024, 1, 128): the scan launches one CTA per (batch, head, P tile),
    with the shared memory of ``smem_bytes``, and the device holds at least
    two of them on an SM, so all 256 are resident at once."""
    case = (4, 1024, 64, 1, 64, 128, 256)
    x, a, b, c = ssd_inputs(case, cuda)
    s0 = torch.zeros((4, 64, 128, 64), device=cuda)
    y, state = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                             return_state=True)
    torch.cuda.synchronize()
    shape = ssd_kernel.last_launch
    assert shape["ctas"] == 4 * 64 and shape["threads"] == 256
    assert shape["smem"] == ssd_kernel.smem_bytes(128) <= 115_712
    assert shape["ctas_per_sm"] >= 2
    assert shape["cb_ctas"] == 4 * 1 * 16
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2"])
def test_smoke_train_step_on_gpu_matches_cpu(cuda, arch, microbatches):
    """The same parameters and batch on both devices, one
    ``make_train_step`` each (AdamW at its defaults): the loss, grad_norm
    and each parameter's Adam moments (the step's gradients) within
    1e-4 x max|cpu|, the updated parameters within 1e-4 x max|cpu| over
    the model (Adam's first step moves an entry by about lr whatever its
    gradient, so one within rounding of 0 may step differently)."""
    cfg = get_smoke(arch)
    cpu_api = build_model(cfg, dtype=torch.float32, device="cpu")
    gpu_api = build_model(cfg, dtype=torch.float32)
    params = cpu_api.init(torch.Generator().manual_seed(0))
    gpu_params = copy.deepcopy(params).to(cuda)
    batch = make_batch(cfg, 4, 32, generator=torch.Generator().manual_seed(2))
    if microbatches > 1:
        batch = {k: v.reshape(microbatches, 4 // microbatches, *v.shape[1:])
                 for k, v in batch.items()}
    out, states = [], []
    for api, p in ((cpu_api, params), (gpu_api, gpu_params)):
        opt = AdamW()
        states.append(opt.init(p))
        out.append(make_train_step(api, opt, microbatches)(
            p, states[-1], {k: v.to(api.device) for k, v in batch.items()}))
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(out[1][name].cpu(), out[0][name],
                                   rtol=1e-4, atol=1e-4)
    for want, got in zip(states[0].m + states[0].v,
                         states[1].m + states[1].v):
        assert float((got.cpu() - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    scale = max(float(p.detach().abs().max()) for p in params.parameters())
    for (name, want), got in zip(params.named_parameters(),
                                 gpu_params.parameters()):
        err = float((got.detach().cpu() - want.detach()).abs().max())
        assert err <= 1e-4 * scale, name


@pytest.mark.cuda
def test_train_smoke_on_gpu_restarts_exactly(cuda, tmp_path):
    """``train(device=None)`` runs on the GPU; an interrupted run resumed
    from its checkpoint gives the uninterrupted run's last losses."""
    kw = dict(smoke=True, batch=4, seq=32, ckpt_every=3, log_every=1000)
    params, full = train("llama3.2-1b", steps=6, ckpt_dir=str(tmp_path / "a"),
                         **kw)
    assert params.embed.device.type == "cuda"
    train("llama3.2-1b", steps=3, ckpt_dir=str(tmp_path / "b"),
          total_steps=6, **kw)
    _, resumed = train("llama3.2-1b", steps=6, ckpt_dir=str(tmp_path / "b"),
                       **kw)
    np.testing.assert_allclose(resumed, full[3:], rtol=1e-5)


def _one_gpu_mesh(cuda, shape, axes):
    from repro_torch.runtime.stap_pipeline import DeviceMesh, _grid

    return DeviceMesh(_grid([cuda] * int(np.prod(shape)), shape), axes)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (1, 2, 2, 1)],
                         ids=["gpipe", "replicated"])
def test_llama_pipeline_on_gpu_equals_decoder_stack(cuda, plan):
    """The Llama smoke config at 8 layers, 4 stages of 2 on one GPU, 3
    microbatches of 2 x 64: bit for bit ``decoder_stack`` run microbatch
    by microbatch (the same kernels on the same shapes; the hops are
    copies), one flash launch per layer and microbatch, and the stages
    the decoder's own layers (a mesh of ``torch.device("cuda")`` shares
    modules on ``cuda:0``)."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.runtime.pipeline import pipeline_forward
    from repro_torch.runtime.stap_pipeline import stap_mesh

    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), n_layers=8)
    api = build_model(cfg, dtype=torch.float32, device=cuda)
    params = api.init(torch.Generator(cuda).manual_seed(0))
    m, mb, s = 3, 2, 64
    xs = torch.randn((m, mb, s, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)).to(cuda)
    positions = torch.arange(s, device=cuda)[None].expand(mb, s)
    seen = set()

    def stage_fn(layers_, x):
        seen.update(id(layer) for layer in layers_)
        for layer in layers_:
            x, _, _ = transformer._sublayer_apply(
                layer, x, cfg, positions, None, None, "flash", "kernel")
        return x

    mesh = _one_gpu_mesh(cuda, (4,), ("stage",)) if plan is None \
        else stap_mesh(4, 2, devices=[cuda] * 8)
    with torch.no_grad():
        want = torch.stack([transformer.decoder_stack(
            params, xs[i], cfg, positions)[0] for i in range(m)])
        flash_kernel.launches = 0
        got = pipeline_forward(stage_fn, [params.layers[2 * i:2 * i + 2]
                                          for i in range(4)], xs, mesh,
                               plan=plan)
        torch.cuda.synchronize()
    assert flash_kernel.launches == cfg.n_layers * m
    assert got.device.type == "cuda" and torch.equal(got, want)
    # the positions on "cuda" ran the decoder's own layers, not copies
    assert seen == {id(layer) for layer in params.layers}


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_moe_ep_on_gpu_matches_cpu(cuda, capacity_factor):
    """Expert parallelism on a (2, 4) mesh of one GPU against the same on
    the CPU (1e-5), and at the no-drop factor against the GPU's local
    path; each position's experts are views of the weights."""
    import dataclasses

    from repro_torch.models.sharding import ShardCtx, use_shardings

    cfg = get_smoke("olmoe-1b-7b")
    mc = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model, mc,
                     torch.float32)
    gp = {name: v.detach().to(cuda) for name, v in p.items()}
    x = torch.randn((4, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    ptrs = []
    local_moe = moe._local_moe

    def spy(x2d, router, w1, w3, w2, **kw):
        ptrs.append(w1.untyped_storage().data_ptr()
                    == gp["w1"].untyped_storage().data_ptr())
        return local_moe(x2d, router, w1, w3, w2, **kw)

    with torch.no_grad():
        with use_shardings(ShardCtx(mesh=_one_gpu_mesh(
                cuda, (2, 4), ("data", "model")))):
            moe._local_moe = spy
            try:
                got, got_aux = moe.moe_sublayer(gp, x.to(cuda), mc)
            finally:
                moe._local_moe = local_moe
        with use_shardings(ShardCtx(mesh=_one_gpu_mesh(
                torch.device("cpu"), (2, 4), ("data", "model")))):
            want, want_aux = moe.moe_sublayer(p, x, mc)
        local, _ = moe.moe_sublayer(gp, x.to(cuda), mc, impl="local")
    assert len(ptrs) == 8 and all(ptrs)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for name in want_aux:
        torch.testing.assert_close(got_aux[name].cpu(), want_aux[name],
                                   rtol=1e-5, atol=1e-5)
    if capacity_factor == 4.0:
        torch.testing.assert_close(got, local, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_allreduce_compressed_on_gpu_matches_cpu(cuda):
    """Four positions of a ("data",) mesh on one GPU against four on the
    CPU: the same int8 payloads, means and residuals within 1e-6 x max."""
    from repro_torch.optim import compression

    gen = torch.Generator().manual_seed(2)
    trees = [[torch.randn(shape, generator=gen) * (i + 1)
              for shape in ((33, 7), (5,), (3, 4, 8))] for i in range(4)]
    results = []
    for dev in (cuda, torch.device("cpu")):
        grads = [[g.to(dev) for g in t] for t in trees]
        results.append(compression.allreduce_compressed(
            grads, [compression.init_ef(g) for g in grads],
            _one_gpu_mesh(dev, (4,), ("data",)), "data"))
    (means, states), (c_means, c_states) = results
    for p in range(4):
        for got, want in zip(means[p] + states[p].residual,
                             c_means[p] + c_states[p].residual):
            assert got.device.type == "cuda"
            tol = 1e-6 * float(want.abs().max())
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_cell_on_gpu_equals_its_meta_record(cuda, kind):
    """Phase 18 of chip_smoke.py at a smoke size: the cell drawn on the
    card on a (1, 1) mesh holds exactly the record's argument and donated
    bytes, and one run of it counts the record's FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun, specs

    cfg, shape = get_smoke("llama3.2-1b"), ShapeCfg("s", 64, 4, kind)
    ctx = specs.make_ctx(_one_gpu_mesh(cuda, (1, 1), ("data", "model")),
                         False, shape)
    rec = dryrun.cell_record(cfg, shape, ctx)
    cell = specs.build_cell(cfg, shape, ctx,
                            generator=torch.Generator(cuda).manual_seed(0))
    leaves = [dryrun.flat_leaves(a, torch.Tensor) for a in cell.args]
    nbytes = [sum(t.numel() * t.element_size() for t in ts) for ts in leaves]
    mem = rec["memory_per_device"]
    assert sum(nbytes) == mem["arguments_bytes"]
    assert sum(nbytes[i] for i in cell.donate_argnums) == mem["alias_bytes"]
    with FlopCounterMode(display=False) as counter:
        cell.fn(*cell.args)
    assert counter.get_total_flops() == rec["cost_per_device"][
        "flops_global"]


@pytest.mark.cuda
def test_quickstart_example_on_gpu_launches_the_fused_span(cuda):
    from repro_torch.examples import quickstart

    before = kernel.counts.launches
    out = quickstart.main([])
    assert kernel.counts.launches > before
    assert out["routes"] == ["pallas"] * len(out["routes"])
    assert out["measured_elems"] == out["predicted_transfers"]
    assert out["max_abs_err"] <= 1e-5

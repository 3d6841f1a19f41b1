"""Measured-cost planning in the port (``occam.calibrate``): the
JSON-shippable ``StageProfile`` and ``CostModel``, the schema-v4
calibration block both ways against reference-written plans, per-stage
measurement with an injected clock, ``Deployment.profile`` against the
reference's stage model, the fit ``occam.calibrate`` takes, the
``packing`` argument, serve-time autoscaling on the CPU (onto pipeline
candidates too), and ``Frontier.serve``, which still raises. One test
runs the autoscaling sequence on the GPU.

The reference package imports JAX, which a GPU machine that has only
PyTorch lacks; its modules come from the ``ref`` fixture, so the GPU
test runs there alone: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_calibrate.py``."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch import occam
from repro_torch.core.graph import chain
from repro_torch.kernels.fused_span import kernel
from repro_torch.occam.calibrate import timers
from repro_torch.occam.calibrate.cost_model import fit_cost_model
from repro_torch.runtime import stap_pipeline

C, P = "conv", "pool"
CAPACITY = 6000
VGG = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
       (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]
# residual edges crossing the cuts: sources ride into later spans
RES = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (C, 3, 1, 1, 8),
       (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]
RES_EDGES = ((1, 3), (0, 4))
POLICIES = ("fp32", "int8", "bf16")


@pytest.fixture
def ref():
    """The reference package's modules (imported here: they import JAX)."""
    from repro import occam as j_occam
    from repro.core.graph import chain as j_chain
    from repro.occam.calibrate.cost_model import fit_cost_model as j_fit
    from repro.runtime import stap_pipeline as j_stap

    return types.SimpleNamespace(occam=j_occam, chain=j_chain, fit=j_fit,
                                 stap=j_stap)


def _vgg(chain_fn=chain):
    return chain_fn("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)


def _res(chain_fn=chain):
    return chain_fn("res_mini", RES, in_h=12, in_w=12, in_ch=3,
                    residual_edges=RES_EDGES)


def _params(net, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((ly.k, ly.k, ly.in_ch, ly.out_ch),
                                      np.float32) * np.float32(0.2),
             "b": rng.standard_normal((ly.out_ch,), np.float32)
             * np.float32(0.01)} if ly.kind == C else {}
            for ly in net.layers]


def _images(net, n, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n,) + net.map_shape(0), np.float32)


# --------------------------------------------------------------------------
# The JSON-shippable records
# --------------------------------------------------------------------------

def test_stage_profile_and_cost_model_round_trip(ref):
    prof = occam.StageProfile(
        spans=((0, 3), (3, 7)), replicas=(2, 1), stage_macs=(1e6, 2e6),
        stage_seconds=(1e-3, 2e-3), payload_elems=(512,), hop_seconds=1e-4,
        microbatch=2, round_batch=4, tick_mean_s=5e-3, tick_count=7,
        tick_busy_fraction=0.5)
    doc = json.loads(json.dumps(prof.to_dict()))
    assert occam.StageProfile.from_dict(doc) == prof
    assert ref.occam.StageProfile.from_dict(doc).to_dict() == doc
    kw = dict(macs_per_s=1e9, stage_overhead_s=1e-3, link_s_per_elem=1e-8,
              hbm_elems_per_s=1e10, analytic_macs_per_s=1e12, samples=3,
              residual=0.1)
    cm = occam.CostModel(**kw)
    doc = json.loads(json.dumps(cm.to_dict()))
    assert occam.CostModel.from_dict(doc) == cm
    assert doc == ref.occam.CostModel(**kw).to_dict()
    with pytest.raises(ValueError, match="newer"):
        occam.CostModel.from_dict({"version": 99, "macs_per_s": 1e9})
    with pytest.raises(ValueError):
        occam.CostModel(macs_per_s=0.0)


@pytest.mark.parametrize("policy", [None, "int8"])
def test_calibration_block_both_ways(ref, policy):
    """A reference plan carrying a calibration block (schema v4, in a v5
    document) loads into an equal port plan and back; the port's
    ``with_calibration`` writes the reference's document; v3-stamped and
    block-less documents load uncalibrated."""
    kw = dict(macs_per_s=2.5e11, stage_overhead_s=2e-4,
              analytic_macs_per_s=33.5e12, samples=6, residual=0.3)
    j_plan = ref.occam.plan(_vgg(ref.chain), CAPACITY, batch=2,
                            dtype_policy=policy)
    doc = j_plan.with_calibration(ref.occam.CostModel(**kw)).to_dict()
    loaded = occam.plan_from_dict(doc)
    assert loaded.calibration == occam.CostModel(**kw)
    assert loaded.to_dict() == doc
    assert ref.occam.plan_from_dict(loaded.to_dict()).to_dict() == doc
    plan = occam.plan(_vgg(), CAPACITY, batch=2, dtype_policy=policy)
    assert plan.calibration is None
    assert plan.to_dict() == j_plan.to_dict()
    cal = plan.with_calibration(occam.CostModel(**kw))
    assert cal.to_dict() == doc
    assert occam.plan_from_json(cal.to_json()).calibration == cal.calibration
    d3 = plan.to_dict()
    d3["version"], d3["quant"] = 3, None
    d3["calibration"] = doc["calibration"]
    assert occam.plan_from_dict(d3).calibration is None
    d4 = cal.to_dict()
    del d4["calibration"]
    assert occam.plan_from_dict(d4).calibration is None


# --------------------------------------------------------------------------
# Stage measurement and profiles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("net_fn", [_vgg, _res])
def test_stage_plan_matches_reference(ref, net_fn):
    """The static half of the STAP module: stages, payloads, spills,
    crossing sources and the MAC model equal the reference's."""
    net, j_net = net_fn(), net_fn(ref.chain)
    for capacity in (1500, CAPACITY, 20_000):
        part = occam.plan(net, capacity).partition
        stages = stap_pipeline.plan_span_stages(net, part)
        j_stages = ref.stap.plan_span_stages(
            j_net, ref.occam.plan(j_net, capacity).partition)
        assert [(s.span, s.route.route, s.route.reason, s.in_spec.keys,
                 s.in_spec.elems, s.out_spec.keys, s.out_spec.elems,
                 s.spill, s.src_keys) for s in stages] == \
            [(s.span, s.route.route, s.route.reason, s.in_spec.keys,
              s.in_spec.elems, s.out_spec.keys, s.out_spec.elems, s.spill,
              s.src_keys) for s in j_stages]
        assert stap_pipeline.model_stage_times(net, stages) == \
            ref.stap.model_stage_times(j_net, j_stages)
        for b in part.boundaries:
            assert dataclasses.astuple(stap_pipeline.payload_spec(net, b)) \
                == dataclasses.astuple(ref.stap.payload_spec(j_net, b))


def test_measure_stage_seconds_is_a_function_of_the_clock():
    """On the CPU each stage is warmed once, then ``iters`` calls sit
    between two clock reads: the tuple is exactly (end - start) / iters
    per stage, in stage order."""
    net = _res()
    plan = occam.plan(net, 1500)
    n = plan.n_spans
    assert n >= 2
    reads = []
    for i in range(n):
        reads += [10.0 * i, 10.0 * i + 0.25 * (i + 1)]
    ticks = iter(reads)
    params = [{k: torch.from_numpy(v) for k, v in p.items()}
              for p in _params(net)]
    got = timers.measure_stage_seconds(net, plan.partition, params,
                                       microbatch=2, iters=3,
                                       routes=plan.routes,
                                       clock=lambda: next(ticks))
    assert got == tuple((reads[2 * i + 1] - reads[2 * i]) / 3
                        for i in range(n))
    with pytest.raises(StopIteration):
        next(ticks)


@pytest.mark.parametrize("policy", [None, "bf16"])
def test_profile_matches_reference_stage_model(ref, policy):
    net, j_net = _res(), _res(ref.chain)
    dep = occam.plan(net, 1500, batch=2, dtype_policy=policy).place(
    ).compile(device="cpu")
    prof = dep.profile(_params(net), iters=2)
    j_stages = ref.stap.plan_span_stages(
        j_net, ref.occam.plan(j_net, 1500, batch=2,
                              dtype_policy=policy).partition)
    assert prof.spans == tuple(s.span for s in j_stages)
    assert prof.stage_macs == ref.stap.model_stage_times(j_net, j_stages)
    assert prof.payload_elems == tuple(s.out_spec.elems
                                       for s in j_stages[:-1])
    assert prof.replicas == (1,) and prof.hop_seconds == 0.0
    assert prof.microbatch == 2 and prof.round_batch == 2
    assert (prof.tick_count, prof.tick_mean_s) == (0, 0.0)
    assert len(prof.stage_seconds) == len(prof.spans)
    assert all(s > 0 for s in prof.stage_seconds)


def test_calibrate_fits_the_profile_as_the_reference(ref, monkeypatch):
    """``occam.calibrate`` fits the profile's stages per image against the
    frontier's fleet: with the measurement pinned, the model equals the
    reference's fit of the same numbers."""
    net = _vgg()
    fleet = occam.Fleet(chips=1, vmem_elems=CAPACITY, macs_per_s=2e12,
                        hbm_elems_per_s=1e9)
    dep = occam.autoplan(net, fleet, batch=2).best().deploy(device="cpu")
    n = dep.plan.n_spans
    secs = tuple(1e-3 * (i + 1) ** 1.5 for i in range(n))
    monkeypatch.setattr(timers, "measure_stage_seconds",
                        lambda *a, **k: secs)
    cm = occam.calibrate(dep, _params(net), rounds=2)
    prof = dep.profile(_params(net))
    j_cm = ref.fit([m for m in prof.stage_macs], [t / 2 for t in secs],
                   hbm_elems_per_s=1e9, analytic_macs_per_s=2e12)
    assert cm.to_dict() == j_cm.to_dict()
    assert cm == fit_cost_model(prof.stage_macs, [t / 2 for t in secs],
                                hbm_elems_per_s=1e9,
                                analytic_macs_per_s=2e12)
    # with no frontier the analytic rate is the module default
    bare = occam.plan(net, CAPACITY).place().compile(device="cpu")
    assert occam.calibrate(bare, _params(net)).analytic_macs_per_s == \
        occam.Fleet(chips=1, vmem_elems=1).macs_per_s


def test_packing_validation():
    plan = occam.plan(_vgg(), CAPACITY)
    with pytest.raises(ValueError, match="pipeline"):
        plan.place(packing="sum")
    # the packing is validated before the multi-chip arguments
    with pytest.raises(ValueError, match="packing"):
        plan.place(chips=4, packing="diagonal")
    placement = plan.place(packing="rect")
    assert placement.packing == "rect"
    assert placement.chips == 1 and placement.replicas == (1,)


# --------------------------------------------------------------------------
# Serve-time autoscaling
# --------------------------------------------------------------------------

def test_scale_and_reconcile_on_cpu_hand_over_between_policies():
    """A one-chip multi-policy frontier: the session scales from the
    throughput pick (bf16, one cut) to ``for_rate``'s candidate with less
    traffic (bf16, two cuts) and back; each
    session's results equal its deployment's ``run``."""
    net = _vgg()
    frontier = occam.autoplan(net, occam.Fleet(chips=1, vmem_elems=CAPACITY,
                                               dtype_policy=POLICIES))
    params = _params(net)
    fast = frontier.best("throughput")
    r_low = 1e-3 * min(c.throughput for c in frontier)
    r_high = 10.0 * max(c.throughput for c in frontier)
    low = frontier.for_rate(r_low)
    assert low is not fast
    dep = fast.deploy(device="cpu")
    with pytest.raises(ValueError, match="no frontier"):
        occam.plan(net, CAPACITY).place().compile(
            device="cpu").reconcile(arrival_rate=1.0)
    assert dep.reconcile(frontier, arrival_rate=r_high) is dep
    xs = _images(net, 5)
    sess = dep.serve(params, round_batch=4)
    sess.submit(xs)
    low_sess = sess.scale(arrival_rate=r_low)
    assert low_sess.deployment is dep.reconcile(arrival_rate=r_low)
    assert low_sess.deployment.candidate is low
    assert low_sess.round_batch == 4
    (_t, y), = sess.results()
    assert torch.equal(y, dep.run(params, xs))
    xs2 = _images(net, 3, seed=2)
    low_sess.submit(xs2)
    (_t, y2), = low_sess.results()
    assert torch.equal(y2, low_sess.deployment.run(params, xs2))
    rep = low_sess.report()
    assert rep.matches_prediction and rep.matches_prediction_bytes
    high = low_sess.scale(arrival_rate=r_high)
    assert high.deployment is dep and high.compile_count == 1


def test_pipeline_picks_and_frontier_serve_raise():
    """Pipeline candidates deploy (every mesh position on the CPU here),
    and reconcile hands a single-device deployment over to one;
    ``Frontier.serve`` runs on the GPU unless told otherwise, so with no
    GPU visible it raises, and with ``device="cpu"`` it returns the
    async engine on the best candidate, armed to autoscale."""
    net = _vgg()
    frontier = occam.autoplan(net, occam.Fleet(chips=6,
                                               vmem_elems=CAPACITY))
    pipe = next(c for c in frontier if c.kind == occam.PIPELINE)
    pdep = pipe.deploy(device="cpu")
    assert pdep.kind == occam.PIPELINE and pdep.candidate is pipe
    assert pdep.placement.packing == pipe.placement().packing
    single = next(c for c in frontier if c.kind == occam.SINGLE)
    dep = single.deploy(device="cpu")
    fast = frontier.for_rate(10.0 * max(c.throughput for c in frontier))
    assert fast.kind == occam.PIPELINE
    fdep = dep.reconcile(arrival_rate=10.0 * fast.throughput)
    assert fdep is fast.deploy(device="cpu") and fdep.candidate is fast
    xs = _images(net, 3)
    assert torch.allclose(fdep.run(_params(net), xs),
                          dep.run(_params(net), xs), rtol=1e-4, atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device="):
            frontier.serve(_params(net))
    eng = frontier.serve(_params(net), device="cpu")
    assert isinstance(eng, occam.AsyncEngine)
    assert eng.deployment is frontier.best().deploy(device="cpu")
    assert eng.describe()["autoscale_armed"]
    assert timers.measure_hop_seconds(fdep.ring(1)) > 0


@pytest.mark.cuda
def test_autoscale_sequence_on_gpu():
    """Phase 4d's autoscale sequence on a small net, on the card: scale
    down to ``for_rate``'s candidate (old results collectable, new ones
    equal to ``run`` bit for bit) and back up to the cached deployment,
    whose captured step is reused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sessions on the GPU replay CUDA "
                    "graphs of the CUDA kernels")
    torch.backends.cudnn.allow_tf32 = False
    net = _vgg()
    frontier = occam.autoplan(net, occam.Fleet(chips=1, vmem_elems=CAPACITY,
                                               dtype_policy=POLICIES))
    params = _params(net)
    fast = frontier.best("throughput")
    r_low = 1e-3 * min(c.throughput for c in frontier)
    r_high = 10.0 * max(c.throughput for c in frontier)
    dep = fast.deploy(device="cuda")
    assert fast.deploy(device=torch.device("cuda")) is dep
    before = kernel.launches
    sess = dep.serve(params, round_batch=4)
    xs = torch.from_numpy(_images(net, 4)).cuda()
    sess.submit(xs)
    low_sess = sess.scale(arrival_rate=r_low)
    assert low_sess.deployment is frontier.for_rate(r_low).deploy(
        device="cuda")
    low_sess.submit(torch.flip(xs, [0]))
    (_t, y_low), = low_sess.results()
    high = low_sess.scale(arrival_rate=r_high)
    (_t, y), = sess.results()
    assert kernel.launches > before
    assert high.deployment is dep and high.compile_count == 1
    assert dep._steps[4].builds == 1
    assert torch.equal(y, dep.run(params, xs))
    assert torch.equal(y_low, low_sess.deployment.run(params,
                                                      torch.flip(xs, [0])))
    prof = dep.profile(params, iters=2)
    assert all(s > 0 for s in prof.stage_seconds)

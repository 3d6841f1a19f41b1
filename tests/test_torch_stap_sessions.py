"""Pipeline sessions of the port's STAP runtime (``Deployment.serve`` on
a ``PIPELINE`` placement, the ring's tick through ``Session``), its
serving geometry, hop timer and calibration, and a frontier's pipeline
candidate deployed and scaled, against the reference's, on the CPU;
split from ``tests/test_torch_stap_pipeline.py`` (whose module docstring
states the setup), from which it takes its helpers and nets."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from conftest import require_devices
from repro import occam as j_occam
from repro_torch import occam
from repro_torch.models import cnn
from repro_torch.occam.calibrate import timers
from repro_torch.runtime import stap_pipeline as sp
from test_torch_stap_pipeline import (CAPACITY, CPU8, _images, _jax,
                                      _oracle, assert_close, vgg)


# --------------------------------------------------------------------------
# Pipeline sessions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(vgg):
    """One replicated pipeline deployment in each package (the ring is
    cached on the deployment, so every session here shares ONE tick
    build)."""
    require_devices(6)
    net, j_net, params, _xs = vgg
    kw = dict(chips=4, max_replicas=2, microbatch=2)
    dep = occam.plan(net, CAPACITY, batch=2).place(devices=CPU8, **kw) \
        .compile()
    j_dep = j_occam.plan(j_net, CAPACITY, batch=2).place(**kw).compile()
    assert dep.placement.replicas == j_dep.placement.replicas == (1, 2, 1)
    return net, params, dep, j_dep


def test_one_compile_across_mixed_submit_sizes(served):
    # reference: test_serve.py::test_one_compile_across_mixed_submit_sizes
    net, params, dep, j_dep = served
    sess, j_sess = dep.serve(params), j_dep.serve(_jax(params))
    rb = sess.round_batch
    assert rb == j_sess.round_batch == 4
    sizes = [1, 3, rb, 2 * rb + 1]
    xs = [_images(net, b, 10 + i) for i, b in enumerate(sizes)]
    tickets = [sess.submit(x) for x in xs]
    for x in xs:
        j_sess.submit(jnp.asarray(x))
    res, j_res = sess.results(), j_sess.results()
    assert sess.compile_count == j_sess.compile_count == 1
    assert [t.uid for t, _ in res] == [t.uid for t in tickets]
    assert [t.images for t, _ in res] == sizes
    for (_t, y), (_jt, j_y) in zip(res, j_res):
        assert_close(y, j_y)
    sess.submit(xs[1])
    (_t2, y2), = sess.results()
    assert_close(y2, _oracle(params, net, xs[1]))
    assert sess.compile_count == 1
    sess2 = dep.serve(params)
    sess2.submit(xs[0])
    sess2.results()
    assert sess2.compile_count == 1
    assert sess.describe()["ring"]["tick_lowerings"] == 1


def test_partial_round_masked_lanes_bit_identical(served):
    # reference: test_serve.py::test_partial_round_masked_lanes_bit_identical
    net, params, dep, _j_dep = served
    s_full, s_part = dep.serve(params), dep.serve(params)
    rb = s_full.round_batch
    xs = _images(net, rb, 42)
    s_full.submit(xs)
    (_, y_full), = s_full.results()
    for n in range(1, rb):
        s_part.submit(xs[:n])
        (_, y_part), = s_part.results()
        assert y_part.shape[0] == n
        assert torch.equal(y_part, y_full[:n])


def test_session_report_masked_lanes_excluded(served):
    # reference: test_serve.py::test_session_report_masked_lanes_excluded
    net, params, dep, _j_dep = served
    sess = dep.serve(params)
    rb = sess.round_batch
    sizes = [1, rb - 1, rb + 2, 2]
    for i, b in enumerate(sizes):
        sess.submit(_images(net, b, 60 + i))
    sess.results()
    rep = sess.report()
    assert rep.images == sum(sizes)
    assert rep.measured_elems == rep.images * rep.offchip_elems
    assert rep.matches_prediction
    assert rep.offchip_elems == cnn.predicted_transfers(
        net, dep.plan.boundaries)
    assert rep.timing is not None and rep.timing["tick_count"] > 0


def test_ticket_ordering_across_replicated_rounds(served):
    # reference: test_serve.py::test_ticket_ordering_across_replicated_rounds
    net, params, dep, j_dep = served
    sess, j_sess = dep.serve(params), j_dep.serve(_jax(params))
    rb = sess.round_batch
    sizes = [rb - 1, 1, 3, rb, 2, 2 * rb + 1]
    xs = [_images(net, b, 80 + i) for i, b in enumerate(sizes)]
    tickets = [sess.submit(x) for x in xs]
    for x in xs:
        j_sess.submit(jnp.asarray(x))
    res, j_res = sess.results(), j_sess.results()
    assert [t.uid for t, _ in res] == [t.uid for t in tickets]
    for (_t, y), (_jt, j_y), x in zip(res, j_res, xs):
        assert_close(y, j_y)
        assert_close(y, _oracle(params, net, x))


def test_ready_peeks_and_the_ring_drains(served):
    # reference: test_serve.py::test_ready_peeks_without_flushing
    net, params, dep, _j_dep = served
    sess = dep.serve(params)
    rb, depth = sess.round_batch, sess.ring_depth
    assert depth == 3
    xs = _images(net, rb, 7)
    t1 = sess.submit(xs)
    assert sess.ready() == () and sess.in_flight_rounds == 1
    later = [sess.submit(xs) for _ in range(depth - 1)]
    assert sess.ready() == (t1,)
    got = sess.results(flush=False)
    assert [t.uid for t, _ in got] == [t1.uid]
    assert_close(got[0][1], _oracle(params, net, xs))
    rest = sess.results()
    assert [t.uid for t, _ in rest] == [t.uid for t in later]
    assert sess.in_flight_rounds == 0 and not sess.pump()
    # pump: one tick a call, a resident round advances toward delivery
    sess.submit(xs)
    assert sess.in_flight_rounds == 1
    assert sess.pump() and sess.pump()
    assert sess.in_flight_rounds == 0 and len(sess.results()) == 1


def test_output_conveyor_banks_o_stream_over_s(served):
    # reference: test_serve.py::test_output_conveyor_banks_o_stream_over_s
    net, params, dep, _j_dep = served
    batch = 16
    pipe = dep.pipeline(batch)
    sched = pipe.schedule
    s, r, rounds = sched.n_stages, sched.max_replicas, sched.n_rounds
    chunk = sp.out_chunk_rounds(rounds, s)
    assert rounds > chunk >= 1
    xs = _images(net, batch, 33)
    staged = sp._round_executor(pipe._fn, pipe._stack_params(params),
                                pipe._pack_feed(torch.from_numpy(xs)),
                                pipe.mesh, sched)
    # each position banks one conveyor chunk, not the whole stream
    assert tuple(staged.shape) == (s * r * chunk, sched.round_width,
                                   pipe.microbatch, pipe.payload_width)
    assert_close(pipe.run(params, xs), _oracle(params, net, xs))


def test_serve_geometry_and_ring_sizing(vgg):
    # reference: test_serve.py::test_serve_geometry_and_ring_sizing
    net, j_net, _params_, _xs = vgg
    for kw in ({}, {"round_batch": 8}):
        pl = occam.plan(net, CAPACITY, batch=2, **kw).place(
            replicas=(1, 2, 1), microbatch=2)
        j_pl = j_occam.plan(j_net, CAPACITY, batch=2, **kw).place(
            replicas=(1, 2, 1), microbatch=2)
        assert pl.ring_depth == j_pl.ring_depth == 3
        assert dataclasses.astuple(pl.steady_schedule()) == \
            dataclasses.astuple(j_pl.steady_schedule())
        assert dataclasses.astuple(pl.schedule(5)) == \
            dataclasses.astuple(j_pl.schedule(5))
        assert (pl.chips, pl.devices_needed) == \
            (j_pl.chips, j_pl.devices_needed) == (4, 6)
        for rb in (None, 2, 6):
            assert pl.serve_geometry(rb) == j_pl.serve_geometry(rb)
        for bad in (3, 0, -2):
            with pytest.raises(ValueError, match="round_batch"):
                pl.serve_geometry(bad)
    assert occam.plan(net, CAPACITY).place(
        replicas=(3, 2, 1), packing="sum").devices_needed == 6


def test_profile_hop_and_calibrate_pipeline(vgg):
    # reference: test_calibrate.py::test_profile_and_calibrate_packed_deployment
    net, _j_net, params, xs = vgg
    dep = occam.plan(net, CAPACITY, batch=2).place(
        replicas=(3, 2, 1), microbatch=2, packing="sum").compile(
        device="cpu")
    with dep.serve(params) as s:
        s.submit(xs)
        s.results()
    prof = dep.profile(params, iters=2)
    assert prof.replicas == (3, 2, 1) and len(prof.stage_seconds) == 3
    assert all(t > 0 for t in prof.stage_seconds)
    assert len(prof.payload_elems) == 2
    assert prof.hop_seconds > 0
    assert prof.tick_count > 0 and prof.round_batch == 12
    assert occam.StageProfile.from_dict(prof.to_dict()) == prof
    cm = occam.calibrate(dep, params, rounds=2)
    assert cm.macs_per_s > 0 and cm.samples == 3
    assert cm.link_s_per_elem > 0
    assert timers.measure_hop_seconds(dep.ring(2)) > 0
    assert dep.report().timing["tick_count"] > 0
    assert dep.describe()["rings"][12]["packing"] == "sum"


def test_pipeline_candidate_deploys_and_scales(vgg):
    # reference: test_calibrate.py::test_rescore_preserves_deployment_cache
    # (a pipeline candidate of autoplan, deployed and served)
    net, j_net, params, xs = vgg
    fleet = dict(chips=6, vmem_elems=CAPACITY)
    frontier = occam.autoplan(net, occam.Fleet(**fleet), batch=2)
    assert frontier.to_dict() == j_occam.autoplan(
        j_net, j_occam.Fleet(**fleet), batch=2).to_dict()
    pipe = next(c for c in frontier if c.kind == occam.PIPELINE)
    dep = pipe.deploy(device="cpu")
    assert dep.kind == occam.PIPELINE and dep.candidate is pipe
    assert dep.placement.replicas == pipe.replicas
    assert pipe.deploy(device="cpu") is dep
    assert_close(dep.run(params, xs), _oracle(params, net, xs))
    # autoscaling from a single-device session onto the fastest pick
    single = next(c for c in frontier if c.kind == occam.SINGLE)
    sess = single.deploy(device="cpu").serve(params, round_batch=2)
    sess.submit(xs[:2])
    fast = frontier.for_rate(10.0 * max(c.throughput for c in frontier))
    assert fast.kind == occam.PIPELINE
    fast_sess = sess.scale(arrival_rate=10.0 * fast.throughput)
    assert fast_sess.deployment.candidate is fast
    (_t, y_old), = sess.results()
    assert_close(y_old, _oracle(params, net, xs[:2]))
    fast_sess.submit(xs)
    (_t, y_new), = fast_sess.results()
    assert_close(y_new, _oracle(params, net, xs))
    assert fast_sess.compile_count == 1
    assert fast_sess.report().matches_prediction

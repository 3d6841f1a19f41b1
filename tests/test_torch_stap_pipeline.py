"""The STAP pipeline of the port (``runtime/stap_pipeline.py``: the
executable half, and the ``PIPELINE`` placement, deployment, sessions and
hop timer) against the reference's, on the CPU.

Every mesh position of the port sits on the CPU (``devices=["cpu"] * n``
or ``compile(device="cpu")``); the reference runs on the 8 emulated CPU
devices of ``tests/conftest.py`` with its Pallas stage bodies in
interpret mode. The same numpy inputs go through both. Schedules, bank
rows, routing, ring states and ``report()`` values are held exactly,
outputs within 1e-4, the int8 pipeline bit for bit. The port's default
device list is the visible CUDA devices (none here), so every placement
that the reference sizes from its 8 emulated devices passes ``devices=``.
Each test names its reference counterpart where it has one."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import require_devices
from repro import occam as j_occam
from repro.core.graph import chain as j_chain
from repro.core.stap import plan_replication as j_plan_replication
from repro.occam.calibrate.placement import pack_replicas as j_pack
from repro.runtime import stap_pipeline as j_sp
from repro_torch import convert, occam
from repro_torch.core.graph import chain
from repro_torch.core.stap import (StapPlan, plan_replication,
                                   staggered_schedule)
from repro_torch.models import cnn
from repro_torch.occam.calibrate import timers
from repro_torch.runtime import stap_pipeline as sp

C, P = "conv", "pool"
CAPACITY = 6000
VGG = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
       (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]
RES = [(C, 3, 1, 1, 4)] * 5
CPU8 = ["cpu"] * 8


def _nets(specs, name="vgg_mini", hw=16, edges=()):
    kw = dict(in_h=hw, in_w=hw, in_ch=3, residual_edges=edges)
    return chain(name, specs, **kw), j_chain(name, specs, **kw)


def _params(net, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((ly.k, ly.k, ly.in_ch, ly.out_ch),
                                      np.float32) * np.float32(0.2),
             "b": rng.standard_normal((ly.out_ch,), np.float32)
             * np.float32(0.1)} if ly.kind == C else {}
            for ly in net.layers]


def _images(net, n, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n,) + net.map_shape(0), np.float32)


def _jax(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


def _oracle(params, net, xs):
    return cnn.reference_forward(convert.params_from_numpy(params),
                                 torch.from_numpy(xs), net).numpy()


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _same_report(got: dict, want: dict, skip=()):
    """Key by key, every value equal but the timing fields named."""
    assert set(got) == set(want)
    for k in set(got) - set(skip):
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def vgg():
    net, j_net = _nets(VGG)
    return net, j_net, _params(net), _images(net, 6)


# --------------------------------------------------------------------------
# Host-side helpers: bank rows, staged outputs, feeds, payload packing
# --------------------------------------------------------------------------

def test_output_bank_rows_and_chunks_equal_reference():
    # reference: test_serve.py::test_output_bank_row_covers_all_rounds
    for s in (1, 2, 3, 5):
        for rounds in (1, 2, 3, 7, 8):
            assert sp.feed_chunk_rounds(rounds, s) == \
                j_sp.feed_chunk_rounds(rounds, s)
            assert sp.out_chunk_rounds(rounds, s) == \
                j_sp.out_chunk_rounds(rounds, s)
            rg = np.arange(rounds)
            assert np.array_equal(sp.output_bank_row(rg, rounds, s),
                                  j_sp.output_bank_row(rg, rounds, s))
            for r in range(rounds):
                assert sp.output_bank_row(r, rounds, s) == \
                    j_sp.output_bank_row(r, rounds, s)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_collect_staged_outputs_and_stage_feed_equal_reference(dtype):
    rng = np.random.default_rng(3)
    for replicas, m in (((1, 1, 1), 5), ((1, 2, 1), 7), ((2, 2), 3)):
        sched = staggered_schedule(_plan(replicas), m)
        s, r, rounds = sched.n_stages, sched.max_replicas, sched.n_rounds
        chunk = sp.out_chunk_rounds(rounds, s)
        staged = (rng.standard_normal((s * r * chunk, sched.round_width, 2,
                                       5)) * 50).astype(dtype)
        got = sp.collect_staged_outputs(torch.from_numpy(staged), sched)
        want = j_sp.collect_staged_outputs(jnp.asarray(staged), sched)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        feed = (rng.standard_normal((rounds, sched.round_width, 2, 5))
                * 50).astype(dtype)
        np.testing.assert_array_equal(
            sp.stage_feed(torch.from_numpy(feed), s).numpy(),
            np.asarray(j_sp.stage_feed(jnp.asarray(feed), s)))


def _plan(replicas):
    times = (1.0,) * len(replicas)
    return StapPlan(times, tuple(replicas), min(replicas), sum(times),
                    sum(replicas))


def test_pack_unpack_equal_reference():
    net, j_net = _nets(RES, "res", 12, ((1, 4), (3, 5)))
    rng = np.random.default_rng(4)
    for cut in (2, 3):
        spec, j_spec = sp.payload_spec(net, cut), j_sp.payload_spec(j_net,
                                                                     cut)
        assert (spec.cut, spec.keys, spec.elems) == \
            (j_spec.cut, j_spec.keys, j_spec.elems)
        parts = {k: rng.standard_normal((2,) + net.map_shape(k), np.float32)
                 for k in spec.keys}
        width = spec.elems + 7
        got = sp._pack({k: torch.from_numpy(v) for k, v in parts.items()},
                       spec, width)
        want = j_sp._pack({k: jnp.asarray(v) for k, v in parts.items()},
                          j_spec, width)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = sp._unpack(got, spec, net)
        j_back = j_sp._unpack(want, j_spec, j_net)
        assert set(back) == set(j_back) == set(spec.keys)
        for k in spec.keys:
            np.testing.assert_array_equal(back[k].numpy(),
                                          np.asarray(j_back[k]))
            np.testing.assert_array_equal(back[k].numpy(), parts[k])
    q = sp._pack({2: torch.ones((1,) + net.map_shape(2), dtype=torch.int8)},
                 sp.PayloadSpec(2, (2,), net.map_elems(2)),
                 net.map_elems(2) + 3)
    assert q.dtype == torch.int8 and int(q.sum()) == net.map_elems(2)


# --------------------------------------------------------------------------
# StapPipeline / stream against the reference
# --------------------------------------------------------------------------

def test_stream_matches_reference_unreplicated(vgg):
    # reference: test_stap_pipeline.py::test_stream_matches_reference_unreplicated
    require_devices(3)
    net, j_net, params, xs = vgg
    plan = occam.plan(net, CAPACITY)
    j_res = j_occam.plan(j_net, CAPACITY).partition
    ctr, j_ctr = cnn.TrafficCounter(), cnn.TrafficCounter()
    y, pipe = sp.stream(params, xs, net, plan.partition, microbatch=2,
                        counter=ctr, devices=["cpu"] * 3)
    j_y, j_pipe = j_sp.stream(_jax(params), jnp.asarray(xs), j_net, j_res,
                              microbatch=2, counter=j_ctr)
    assert pipe.plan.replicas == j_pipe.plan.replicas == (1, 1, 1)
    assert_close(y, j_y)
    assert_close(y, _oracle(params, net, xs))
    assert (ctr.reads, ctr.writes) == (j_ctr.reads, j_ctr.writes)
    assert ctr.total == xs.shape[0] * cnn.predicted_transfers(
        net, plan.boundaries)
    _same_report(pipe.report(), j_pipe.report())


def test_staged_replicated_matches_reference(vgg):
    # reference: test_stap_pipeline.py::test_staged_replicated_matches_reference
    require_devices(6)
    net, j_net, params, xs = vgg
    stages = sp.plan_span_stages(net, occam.plan(net, CAPACITY).partition)
    times = sp.model_stage_times(net, stages)
    kw = dict(chips=len(times) + 1, stage_times=times, microbatch=2)
    dep = occam.plan(net, CAPACITY, batch=2).place(devices=CPU8, **kw) \
        .compile()
    j_dep = j_occam.plan(j_net, CAPACITY, batch=2).place(**kw).compile()
    assert dep.placement.replicas == j_dep.placement.replicas
    assert max(dep.placement.replicas) == 2
    y = dep.run(params, xs)
    assert_close(y, j_dep.run(_jax(params), jnp.asarray(xs)))
    _same_report(dep.pipeline(6).report(), j_dep.pipeline(6).report())
    rep, j_rep = dep.report(), j_dep.report()
    assert rep.matches_prediction and rep.measured_elems == \
        j_rep.measured_elems
    desc, j_desc = dep.describe(), j_dep.describe()
    for k in ("kind", "replicas", "chips", "microbatch", "images_run",
              "measured_transfers", "routes"):
        assert desc[k] == j_desc[k], k
    assert desc["pipelines"][6] == \
        {k: v for k, v in j_desc["pipelines"][6].items()}


def test_stream_residual_spans_and_traffic():
    # reference: test_stap_pipeline.py::test_stream_residual_spans_and_traffic
    require_devices(3)
    net, j_net = _nets(RES, "res", 12, ((1, 4), (3, 5)))
    params, xs = _params(net, 5), _images(net, 4, 6)
    ctr = cnn.TrafficCounter()
    y, pipe = sp.stream(params, xs, net, [2, 3], microbatch=2, counter=ctr,
                        devices=["cpu"] * 3)
    j_y, j_pipe = j_sp.stream(_jax(params), jnp.asarray(xs), j_net, [2, 3],
                              microbatch=2)
    assert_close(y, j_y)
    assert_close(y, _oracle(params, net, xs))
    assert ctr.total == 4 * cnn.predicted_transfers(net, [2, 3])
    assert pipe.stages[0].out_spec.keys == (2, 1)
    assert pipe.stages[1].out_spec.keys == (3, 1)
    assert pipe.stages[2].src_keys == (1,)
    _same_report(pipe.report(), j_pipe.report())


def test_stream_replicated_residual():
    # reference: test_stap_pipeline.py::test_stream_replicated_residual
    require_devices(6)
    net, j_net = _nets(RES, "res", 12, ((1, 4),))
    params, xs = _params(net, 2), _images(net, 6, 3)
    plan = plan_replication((1.0, 4.0, 1.0), max_chips=4)
    j_plan = j_plan_replication((1.0, 4.0, 1.0), max_chips=4)
    assert plan.replicas == j_plan.replicas == (1, 2, 1)
    y, pipe = sp.stream(params, xs, net, [2, 3], plan=plan, devices=CPU8)
    j_y, j_pipe = j_sp.stream(_jax(params), jnp.asarray(xs), j_net, [2, 3],
                              plan=j_plan)
    assert_close(y, j_y)
    assert_close(y, _oracle(params, net, xs))
    _same_report(pipe.report(), j_pipe.report())


def test_stream_pads_partial_batches():
    # reference: test_stap_pipeline.py::test_stream_pads_partial_batches
    require_devices(4)
    specs = [(C, 3, 1, 1, 4), (C, 3, 2, 1, 8)]
    net, j_net = _nets(specs, "t", 10)
    params, xs = _params(net), _images(net, 5)
    plan = plan_replication((1.0, 1.0), max_chips=4)
    assert plan.replicas == (2, 2)
    y, pipe = sp.stream(params, xs, net, [1], microbatch=2, plan=plan,
                        devices=["cpu"] * 4)
    j_y, _ = j_sp.stream(_jax(params), jnp.asarray(xs), j_net, [1],
                         microbatch=2,
                         plan=j_plan_replication((1.0, 1.0), max_chips=4))
    assert pipe.schedule.n_slots * pipe.microbatch > 5
    assert tuple(y.shape) == (5,) + net.map_shape(2)
    assert_close(y, j_y)


def test_single_stage_pipeline():
    # reference: test_stap_pipeline.py::test_single_stage_pipeline
    net, j_net = _nets([(C, 3, 1, 1, 4)], "t", 8)
    params, xs = _params(net), _images(net, 3)
    y, pipe = sp.stream(params, xs, net, [], microbatch=2, devices=["cpu"])
    j_y, j_pipe = j_sp.stream(_jax(params), jnp.asarray(xs), j_net, [],
                              microbatch=2)
    assert_close(y, j_y)
    _same_report(pipe.report(), j_pipe.report())


def test_oracle_route_runs_in_pipeline():
    # reference: test_stap_pipeline.py::test_oracle_route_runs_in_pipeline
    require_devices(2)
    net, j_net = _nets([(C, 3, 1, 1, 8), (C, 3, 1, 1, 8)], "t", 10)
    plan = occam.plan(net, 400)
    assert any(not s.fits for s in plan.partition.spans)
    assert "oracle" in [r.route for r in plan.routes]
    params, xs = _params(net), _images(net, 2)
    y, pipe = sp.stream(params, xs, net, plan.partition,
                        devices=["cpu"] * 2)
    j_y, j_pipe = j_sp.stream(_jax(params), jnp.asarray(xs), j_net,
                              j_occam.plan(j_net, 400).partition)
    assert "oracle" in pipe.report()["engines"]
    assert_close(y, j_y)
    _same_report(pipe.report(), j_pipe.report())


def test_natural_chip_budget_caps_replicas_to_devices(vgg):
    # reference: test_stap_pipeline.py::test_natural_chip_budget_caps_replicas_to_devices
    require_devices(8)
    net, j_net, _params_, _xs = vgg
    part = occam.plan(net, CAPACITY).partition
    pipe = sp.StapPipeline(net, part, 4, 2, max_chips=8, devices=CPU8)
    j_pipe = j_sp.StapPipeline(j_net, j_occam.plan(j_net, CAPACITY)
                               .partition, 4, 2, max_chips=8)
    assert dataclasses.astuple(pipe.plan) == dataclasses.astuple(j_pipe.plan)
    assert pipe.schedule.n_stages * pipe.schedule.max_replicas <= 8
    assert max(pipe.plan.replicas) >= 2
    # without a device list the port counts the visible CUDA devices
    # (none here): no replication
    stages = sp.plan_span_stages(net, part)
    times = sp.model_stage_times(net, stages)
    assert sp.default_stap_plan(times, max_chips=8).replicas == (1, 1, 1)


def test_mismatched_and_mixed_meshes_raise(vgg):
    # reference: test_stap_pipeline.py::test_mismatched_mesh_raises
    net, _j_net, params, xs = vgg
    part = occam.plan(net, CAPACITY).partition
    pipe = sp.StapPipeline(net, part, 6, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="schedule needs"):
        sp._round_executor(pipe._fn, pipe._stack_params(params),
                           pipe._pack_feed(torch.from_numpy(xs)),
                           sp.stap_mesh(3, 2, CPU8), pipe.schedule)
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        sp.stap_mesh(3, 1, ["cpu", "cuda:0", "cpu"])
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        occam.plan(net, CAPACITY).place(replicas=(1, 1, 1)).compile(
            devices=["cpu", "cpu", "cuda:0"])
    with pytest.raises(ValueError, match=r"cuda:0.*\* 6"):
        sp.stap_mesh(3, 2, ["cpu"] * 5)
    placement = occam.plan(net, CAPACITY).place(replicas=(1, 2, 1))
    with pytest.raises(RuntimeError, match='device="cuda:0"'):
        placement.compile()
    with pytest.raises(ValueError, match="not both"):
        placement.compile(device="cpu", devices=CPU8)


# --------------------------------------------------------------------------
# StapRing ticks: states, lanes and routing against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("replicas,packing", [((1, 2, 1), "rect"),
                                              ((3, 2, 1), "sum")])
def test_ring_tick_matches_reference(vgg, replicas, packing):
    # reference: test_serve.py::test_ring_state_is_one_round_per_chip and
    # test_calibrate.py::test_packed_ring_serves_unbalanced_plan_exactly
    require_devices(6)
    net, j_net, params, _xs = vgg
    dep = occam.plan(net, CAPACITY, batch=2).place(
        replicas=replicas, microbatch=2, packing=packing).compile(
        device="cpu")
    j_dep = j_occam.plan(j_net, CAPACITY, batch=2).place(
        replicas=replicas, microbatch=2, packing=packing).compile()
    ring, j_ring = dep.ring(2), j_dep.ring(2)
    n_pos = dep.placement.devices_needed
    state, j_state = ring.init_state(), j_ring.init_state()
    assert len(state) == n_pos and j_state.shape[0] == n_pos * \
        ring.round_width
    rng = np.random.default_rng(7)
    for t in range(ring.ring_depth + 2):
        xs = _images(net, ring.round_batch, 20 + t)
        in_round = ring.pack_round(xs)
        j_in = j_ring.pack_round(jnp.asarray(xs))
        np.testing.assert_array_equal(in_round.numpy(), np.asarray(j_in))
        masks = rng.random((ring.ring_depth, ring.round_width)) < 0.7
        state, lanes = ring.tick(params, state, in_round, masks)
        j_state, j_lanes = j_ring.tick(_jax(params), j_state, j_in, masks)
        # one round of ring state per position, routed as the reference
        # routes it (zeros where no replica sends)
        got = torch.stack(state).numpy()
        want = np.asarray(j_state).reshape(got.shape)
        assert {tuple(s.shape) for s in state} == \
            {(ring.round_width, 2, ring.payload_width)}
        np.testing.assert_array_equal(got == 0, want == 0)
        assert_close(got, want)
        assert tuple(lanes.shape) == (ring.round_batch,) + \
            net.map_shape(net.n_layers)
        assert_close(lanes, j_lanes)
    assert ring.trace_count == j_ring.trace_count == 1
    _same_report(ring.report(), j_ring.report(),
                 skip=("tick_mean_s", "tick_busy_fraction"))


def test_packed_ring_432_on_nine_positions(vgg):
    # reference: test_calibrate.py::test_four_three_two_serves_on_nine_chips
    # (the reference needs a 9-device host for it; here the port serves
    # it on 9 CPU positions against the reference's pipeline on 3)
    require_devices(3)
    net, j_net, params, _xs = vgg
    plan = occam.plan(net, CAPACITY)
    dep = plan.place(replicas=(4, 3, 2), packing="sum").compile(
        device="cpu")
    assert dep.placement.devices_needed == dep.placement.chips == 9
    assert dep.mesh.shape == {"chip": 9}
    assert j_pack((4, 3, 2)).stage_ids() == dep.ring(1)._position_stages()
    xs = _images(net, 24, 9)
    with dep.serve(params) as s:
        s.submit(xs)
        [(_t, y)] = s.results()
        rep = s.report()
        assert s.compile_count == 1
    j_y, _ = j_sp.stream(_jax(params), jnp.asarray(xs), j_net,
                         j_occam.plan(j_net, CAPACITY).partition)
    assert_close(y, j_y)
    assert rep.matches_prediction


def test_sum_packed_run_needs_the_rect_grid(vgg):
    # the port's own: a sum-packed deployment serves on its packed mesh,
    # while run() executes the rectangular batch program, which needs the
    # full (stage, replica) grid of positions
    net, j_net, params, xs = vgg
    place = occam.plan(net, CAPACITY).place(replicas=(3, 2, 1),
                                            packing="sum")
    short = place.compile(devices=["cpu"] * place.chips)
    with short.serve(params, round_batch=6) as s:
        s.submit(xs[:6])
        [(_t, y_served)] = s.results()
    with pytest.raises(ValueError, match="rectangular batch program, whose "
                                         "mesh has 9 positions"):
        short.run(params, xs)
    full = place.compile(devices=["cpu"] * 9)
    assert full.mesh.shape == {"chip": 6}
    y = full.run(params, xs)
    j_y, _ = j_sp.stream(_jax(params), jnp.asarray(xs), j_net,
                         j_occam.plan(j_net, CAPACITY).partition)
    assert_close(y, j_y)
    assert_close(y_served, j_y[:6])


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


def test_place_argument_errors_match_reference(vgg):
    # reference: place.py's ValueErrors, test_calibrate.py::
    # test_single_placement_rejects_sum_packing
    net, j_net, _params_, _xs = vgg
    plan, j_plan = occam.plan(net, CAPACITY), j_occam.plan(j_net, CAPACITY)
    for kw, match in (
            (dict(replicas=(1, 2, 1), chips=4), "conflicts"),
            (dict(replicas=(1, 2)), "replica counts"),
            (dict(pipeline=False, chips=4), "pipeline=False"),
            (dict(packing="sum"), "pipeline"),
            (dict(chips=4, packing="diagonal"), "packing"),
            (dict(stage_times=(1.0,)), "stage times")):
        with pytest.raises(ValueError, match=match):
            plan.place(**kw)
        with pytest.raises(ValueError, match=match):
            j_plan.place(**kw)
    pl = plan.place(pipeline=True, devices=CPU8, harmonize=True)
    assert dataclasses.astuple(pl.stap) == dataclasses.astuple(
        j_plan.place(pipeline=True, harmonize=True).stap)
    assert pl.devices == tuple(torch.device("cpu") for _ in range(8))
    mesh = sp.stap_mesh(3, 2, CPU8)
    pl = plan.place(mesh=mesh)
    assert pl.stap.replicas == j_plan.place(
        mesh=j_sp.stap_mesh(3, 2)).stap.replicas
    assert pl.compile().mesh.shape == mesh.shape


# --------------------------------------------------------------------------
# Dtype policy, profiles, the frontier
# --------------------------------------------------------------------------

def test_int8_pipeline_bit_equal_to_reference(vgg):
    # reference: test_quant.py::test_int8_pipeline_bit_identical_and_fewer_link_bytes
    # and test_quant.py::test_serving_session_bytes_exact
    require_devices(3)
    net, j_net, params, _xs = vgg
    xs = _images(net, 6, 11) * np.float32(0.5)
    plan = occam.plan(net, CAPACITY, batch=6, dtype_policy="int8")
    j_plan = j_occam.plan(j_net, CAPACITY, batch=6, dtype_policy="int8")
    n = plan.n_spans
    dep = plan.place(chips=n, devices=["cpu"] * n).compile()
    j_dep = j_plan.place(chips=n).compile()
    y = dep.run(params, xs)
    j_y = np.asarray(j_dep.run(_jax(params), jnp.asarray(xs)))
    np.testing.assert_array_equal(y.numpy(), j_y)
    assert torch.equal(y, plan.place().compile(device="cpu").run(params, xs))
    rep = dep.report()
    assert rep.matches_prediction and rep.matches_prediction_bytes
    assert rep.measured_bytes == j_dep.report().measured_bytes
    pr = dep.pipeline(6).report()
    _same_report(pr, j_dep.pipeline(6).report())
    assert pr["payload_bytes_per_elem"] == 1.0
    f32 = occam.plan(net, CAPACITY, batch=6)
    assert pr["link_bytes_per_image"] < f32.place(
        chips=f32.n_spans, devices=CPU8).compile().pipeline(6).report()[
        "link_bytes_per_image"]
    with dep.serve(params) as sess:
        assert all(s.dtype == torch.int8 for s in sess._state)
        t = sess.submit(xs)
        got = dict((tk.uid, v) for tk, v in sess.results())
        rep = sess.report()
    assert torch.equal(got[t.uid], y)
    assert rep.matches_prediction and rep.matches_prediction_bytes


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


def test_spmd_bodies_drive_pipeline_stages(vgg):
    # reference: test_serve.py::test_spmd_body_resolution,
    # test_registered_spmd_body_drives_pipeline_stage and
    # test_pallas_stage_bodies_drive_the_pipeline
    assert occam.resolve_spmd_engine("scan").name == "scan"
    assert occam.resolve_spmd_engine("oracle").name == "oracle"
    assert occam.resolve_spmd_engine("pallas").name == "pallas"
    with pytest.raises(occam.BackendError, match="SPMD"):
        occam.resolve_spmd_engine("interpreted")
    net, j_net = _nets([(C, 3, 1, 1, 4), (C, 3, 1, 1, 4)], "t", 8)
    params, xs = _params(net), _images(net, 2)
    pipe = sp.StapPipeline(net, [1], 2, 1, out_rows=2, devices=["cpu"] * 2)
    assert pipe.report()["engines"] == ["pallas", "pallas"]
    assert_close(pipe.run(params, xs), _oracle(params, net, xs))
    built, executed = [], []
    oracle = occam.get_engine("oracle")

    def make_body(net_, a, b, spill, src_keys, *, out_rows=1):
        built.append((a, b))
        inner = oracle.make_spmd_body(net_, a, b, spill, src_keys,
                                      out_rows=out_rows)

        def body(span_params, x, srcs):
            executed.append((a, b))
            return inner(span_params, x, srcs)

        return body

    occam.register_engine(
        "test_spmd", priority=1, accepts=lambda n, a, b, c: (True, "test"),
        run=oracle.run, spmd_capable=True, make_spmd_body=make_body)
    try:
        pipe = sp.StapPipeline(net, [1], 2, 1, devices=["cpu"] * 2)
        assert [pipe.executed_engine(st) for st in pipe.stages] == \
            ["test_spmd"] * 2
        y = pipe.run(params, xs)
        assert built == [(0, 1), (1, 2)] and executed
        assert_close(y, _oracle(params, net, xs))
    finally:
        occam.unregister_engine("test_spmd")
    placement = occam.plan(net, 10**6).place(replicas=(1,))
    with pytest.raises(occam.BackendError, match="spmd_capable"):
        placement.compile("interpreted", device="cpu")
    assert [r.route for r in placement.compile(
        "scan", device="cpu").routes] == ["scan"]

"""The port's async serving engine (``repro_torch.occam.serve``) on the
CPU: the reference's tests (``tests/test_async_engine.py``) on
``device="cpu"``, and a twin test that drives the port's engine and the
reference's through the same submit sequence under the same injected
clock.

The shared ``engine_case`` is a replicated pipeline candidate of an
``autoplan`` frontier with every mesh position on the CPU (the reference
runs it on its emulated devices). Every coroutine is driven by
``asyncio.run`` under ``asyncio.wait_for`` with a time limit, so an engine
whose serving loop died fails its test instead of hanging the suite.
Each test names its reference counterpart where it has one.
"""
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import require_devices
from repro import occam as j_occam
from repro.core.graph import chain as j_chain
from repro_torch import convert, occam
from repro_torch.core.graph import chain
from repro_torch.models import cnn
from repro_torch.occam.serve import (AdmissionError, AdmissionQueue,
                                     MetricsRing, Router, percentile)

C, P = "conv", "pool"
CAPACITY = 6000
VGG = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
       (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]
LIMIT_S = 120.0


def _nets(hw=16):
    kw = dict(in_h=hw, in_w=hw, in_ch=3)
    return chain("vgg_mini", VGG, **kw), j_chain("vgg_mini", VGG, **kw)


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


def _ref(params, net, xs):
    return cnn.reference_forward(convert.params_from_numpy(params),
                                 torch.from_numpy(xs), net)


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def run(coro, limit: float = LIMIT_S):
    """``asyncio.run`` with a time limit: a hung engine fails the test."""
    return asyncio.run(asyncio.wait_for(coro, limit))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module. The CPU runs the kernels' plain
    versions as many tiny row operations; with torch's default thread pool
    on a host that parallel test workers load, each operation waits for
    descheduled threads, and a ring session that takes a second alone has
    taken minutes, past the engine tests' time limit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engine_case():
    """One replicated pipeline deployment (every position on the CPU) and
    its planning frontier, shared by the engine tests (rings are cached
    on deployments: every engine and session here shares one tick
    build)."""
    net = _nets()[0]
    params = _params(net)
    frontier = occam.autoplan(net, occam.Fleet(chips=6, vmem_elems=CAPACITY),
                              batch=2)
    assert any(c.kind == occam.PIPELINE for c in frontier)
    dep = frontier.best("throughput").deploy(device="cpu")
    assert dep.kind == occam.PIPELINE
    return net, params, frontier, dep


# --------------------------------------------------------------------------
# Metrics ring and admission queue (host-side, no devices)
# --------------------------------------------------------------------------

def test_percentile_interpolates():
    # reference: test_percentile_interpolates
    assert percentile([], 99) is None
    assert percentile([5.0], 50) == 5.0
    xs = [1.0, 2.0, 3.0, 4.0]
    assert (percentile(xs, 0), percentile(xs, 100), percentile(xs, 50)) == \
        (1.0, 4.0, 2.5)


def test_metrics_ring_windows_and_rates():
    # reference: test_metrics_ring_windows_and_rates
    now = [0.0]
    ring = MetricsRing(window_s=1.0, windows=4, clock=lambda: now[0])
    ring.observe_arrival(4, queue_depth=4)
    ring.observe_round(4, 4)
    ring.observe_completion(4, 0.25)
    assert ring.roll() == [] and ring.arrival_rate() == 0.0
    now[0] = 1.5
    (w,) = ring.roll()
    assert (w.arrivals, w.completions, w.rounds) == (4, 4, 1)
    assert w.arrival_rate == 4.0 and w.occupancy == 1.0
    now[0] = 3.5
    assert [w2.arrivals for w2 in ring.roll()] == [0, 0]
    assert ring.arrival_rate() == pytest.approx(4.0 / 3)
    assert ring.arrival_rate(windows=2) == 0.0
    now[0] = 1e6
    ring.roll()
    assert len(ring.closed_windows) == 4 and ring.arrival_rate() == 0.0
    snap = ring.snapshot()
    assert snap["total_arrivals"] == 4 and snap["total_completions"] == 4
    assert snap["latency_p50_s"] == 0.25


def test_metrics_ring_occupancy_aggregates():
    # reference: test_metrics_ring_occupancy_aggregates
    now = [0.0]
    ring = MetricsRing(window_s=1.0, windows=8, clock=lambda: now[0])
    ring.observe_round(4, 4)
    ring.observe_round(1, 4)
    now[0] = 1.1
    ring.roll()
    assert ring.snapshot()["round_occupancy"] == pytest.approx(5 / 8)


class _Future:
    def done(self):
        return False


def test_admission_is_per_tenant():
    # reference: test_admission_is_per_tenant
    now = [0.0]
    q = AdmissionQueue(max_pending=4, clock=lambda: now[0])

    def offer(tenant, n):
        return q.offer(tenant, np.zeros((n, 2)), n, _Future())

    a1 = offer("a", 3)
    with pytest.raises(AdmissionError, match="max_pending=4"):
        offer("a", 2)
    assert q.rejections == 1
    offer("b", 4)
    assert (q.pending("a"), q.pending("b"), q.depth) == (3, 4, 7)
    segs = q.take(5)
    assert [(r.tenant, t) for r, _lanes, t in segs] == [("a", 3), ("b", 2)]
    assert q.depth == 2 and q.pending("a") == 3
    q.settle(a1, 3)
    assert q.pending("a") == 0
    offer("a", 4)
    now[0] = 2.5
    assert q.oldest_wait() == pytest.approx(2.5)


def test_queue_cancel_masks_out_of_take():
    # reference: test_queue_cancel_masks_out_of_take
    loop = asyncio.new_event_loop()
    try:
        q = AdmissionQueue(max_pending=8)
        r1 = q.offer("a", np.zeros((3, 4, 4, 3)), 3, loop.create_future())
        r2 = q.offer("a", np.zeros((2, 4, 4, 3)), 2, loop.create_future())
        assert q.cancel(r1) == 3
        assert (q.depth, q.pending("a"), r1.remaining) == (2, 2, 0)
        assert [(r is r2, t) for r, _l, t in q.take(8)] == [(True, 2)]
        r3 = q.offer("b", np.zeros((4, 4, 4, 3)), 4, loop.create_future())
        (req, _lanes, take), = q.take(1)
        assert req is r3 and take == 1
        assert q.cancel(r3) == 3
        assert (q.depth, q.pending("b"), r3.remaining) == (0, 1, 1)
        assert q.take(8) == [] and q.cancellations == 2
    finally:
        loop.close()


# --------------------------------------------------------------------------
# Zero new builds under a mixed multi-tenant async load
# --------------------------------------------------------------------------

def test_engine_zero_new_builds_vs_bare_session(engine_case):
    # reference: test_engine_zero_new_lowerings_vs_bare_session
    net, params, _frontier, dep = engine_case
    sizes = [1, 3, 0, 2, 2]

    async def drive():
        eng = occam.AsyncEngine(dep, params, max_wait_ms=25.0,
                                max_pending=64)
        async with eng:
            rb = eng.round_batch
            mix = [b if b else rb for b in sizes] + [2 * rb + 1]
            xs = [_images(net, b, 10 + i) for i, b in enumerate(mix)]
            tickets = [await eng.submit(x, tenant=f"t{i % 3}")
                       for i, x in enumerate(xs)]
            outs = await asyncio.gather(*tickets)
            for y, x in zip(outs, xs):
                assert isinstance(y, torch.Tensor)
                assert y.shape[0] == x.shape[0]
                assert_close(y, _ref(params, net, x))
            return mix, xs, eng.compile_count, eng.describe()

    mix, xs, engine_compiles, desc = run(drive())
    sess = dep.serve(params)
    for x in xs:
        sess.submit(x)
    sess.results()
    assert engine_compiles == sess.compile_count == 1
    assert desc["metrics"]["total_arrivals"] == sum(mix)
    assert desc["metrics"]["total_completions"] == sum(mix)
    assert desc["packs_overlapped"] >= 1
    assert desc["metrics"]["latency_p99_s"] > 0
    assert desc["session"]["kind"] == occam.PIPELINE


# --------------------------------------------------------------------------
# Per-tenant admission control, and the front door's own checks
# --------------------------------------------------------------------------

def test_per_tenant_backpressure(engine_case):
    # reference: test_per_tenant_backpressure
    net, params, _frontier, dep = engine_case

    async def drive():
        eng = occam.AsyncEngine(dep, params, max_pending=4,
                                max_wait_ms=25.0)
        async with eng:
            x1 = _images(net, 1, 1)
            held = [await eng.submit(x1, tenant="greedy") for _ in range(4)]
            with pytest.raises(occam.AdmissionError, match="greedy"):
                await eng.submit(x1, tenant="greedy")
            ok = await eng.submit(x1, tenant="patient")
            assert eng.queue.rejections == 1
            await eng.drain()
            await asyncio.gather(ok, *held)
            t = await eng.submit(x1, tenant="greedy")
            assert_close(await t, _ref(params, net, x1))
            with pytest.raises(ValueError, match="images"):
                await eng.submit(np.zeros((2, 7, 7, 3), np.float32))
            assert eng.queue.pending("greedy") == 0

    run(drive())


def test_dtype_checked_at_the_front_door(engine_case):
    """An image dtype the session would refuse raises ``ValueError`` at
    ``submit``, with the session's own message, before admission; the
    serving loop stays alive and serves the next, well-typed request
    (numpy or a tensor)."""
    net, params, _frontier, dep = engine_case
    sess = dep.serve(params)
    x1 = _images(net, 1, 3)
    with pytest.raises(ValueError) as want:
        sess.submit(x1.astype(np.float64))
    sess.close()

    async def drive():
        eng = occam.AsyncEngine(dep, params, max_wait_ms=5.0)
        async with eng:
            with pytest.raises(ValueError) as got:
                await eng.submit(x1.astype(np.float64))
            assert str(got.value) == str(want.value)
            with pytest.raises(ValueError, match="torch.float32"):
                await eng.submit(torch.from_numpy(x1).to(torch.bfloat16))
            assert eng.queue.depth == 0 and eng.queue.rejections == 0
            y = await (await eng.submit(torch.from_numpy(x1)))
            assert not eng._task.done()
            return y

    assert_close(run(drive()), _ref(params, net, x1))


def test_aged_submit_flushes_while_later_tenant_backpressured(engine_case):
    # reference: test_aged_submit_flushes_while_later_tenant_backpressured
    net, params, _frontier, dep = engine_case

    async def drive():
        eng = occam.AsyncEngine(dep, params, max_pending=2,
                                max_wait_ms=30.0)
        async with eng:
            x1 = _images(net, 1, 2)
            lone = await eng.submit(x1, tenant="slow")
            for _ in range(2):
                await eng.submit(x1, tenant="greedy")
            with pytest.raises(occam.AdmissionError):
                await eng.submit(x1, tenant="greedy")
            y = await asyncio.wait_for(asyncio.ensure_future(lone), 30.0)
            assert_close(y, _ref(params, net, x1))
            assert lone.done()

    run(drive())


# --------------------------------------------------------------------------
# Session.pump and the queue-side fields the engine samples
# --------------------------------------------------------------------------

def test_session_pump_single_ticks(engine_case):
    # reference: test_session_pump_single_ticks
    net, params, _frontier, dep = engine_case
    sess = dep.serve(params)
    rb, depth = sess.round_batch, sess.ring_depth
    assert not sess.pump()
    x = _images(net, 1, 3)
    t = sess.submit(x)
    assert sess.describe()["pending_lanes"] == 1
    assert not sess.pump()
    assert sess.pump(allow_partial=True)
    assert sess.describe()["pending_lanes"] == 0
    assert sess.in_flight_rounds == 1
    assert sess.describe()["flush_count"] == 0
    for _ in range(depth - 1):
        assert sess.pump()
    got = sess.results(flush=False)
    assert [tk.uid for tk, _ in got] == [t.uid]
    assert_close(got[0][1], _ref(params, net, x))
    assert not sess.pump()
    sess.submit(_images(net, rb, 4))
    assert sess.describe()["pending_lanes"] == 0
    sess.results()


def test_session_queue_side_describe_and_report(engine_case):
    # reference: test_session_queue_side_describe_and_report
    net, params, _frontier, dep = engine_case
    sess = dep.serve(params, max_wait_ticks=2)
    rb = sess.round_batch
    x = _images(net, rb, 5)
    sess.submit(x)
    sess.submit(x[:1])
    d = sess.describe()
    assert d["pending_lanes"] == 1 and d["rounds_served"] == 1
    assert d["in_flight_rounds"] == sess.in_flight_rounds >= 1
    assert d["flush_count"] == 0 and d["waited_ticks"] == 0
    sess.ready()
    sess.ready()
    d = sess.describe()
    assert d["waited_ticks"] == 2 and d["flush_count"] == 1
    assert d["pending_lanes"] == 0 and d["rounds_served"] == 2
    rep = sess.report()
    assert isinstance(rep.serving, occam.ServingStats)
    assert (rep.serving.rounds_served, rep.serving.flush_count,
            rep.serving.waited_ticks, rep.serving.pending_lanes) == \
        (2, 1, 2, 0)
    assert rep.matches_prediction
    sess.results()
    assert dep.report().serving is None


def test_serving_stats_utilization(engine_case):
    """``serving_stats()``: the session's counters and one utilization per
    pipeline stage (the tick duty cycle scaled by each stage's share of
    the bottleneck; the bottleneck stage's equals the duty cycle), one
    for a single-device deployment."""
    net, params, frontier, dep = engine_case
    single = next(c for c in frontier if c.kind == occam.SINGLE)

    async def drive(d):
        eng = occam.AsyncEngine(d, params, round_batch=dep.placement
                                .serve_geometry(None)[0])
        async with eng:
            await eng.submit(_images(net, eng.round_batch, 6))
            await eng.drain()
            return eng.serving_stats()

    stats = run(drive(dep))
    plan = dep.placement.stap
    per = [t / r for t, r in zip(plan.stage_times, plan.replicas)]
    util = stats["utilization"]
    assert len(util) == len(plan.replicas) and stats["rounds_served"] == 1
    duty = util[per.index(max(per))]
    assert 0 < duty <= 1
    assert util == pytest.approx(tuple(duty * t / max(per) for t in per))
    assert len(run(drive(single.deploy(device="cpu")))["utilization"]) == 1


# --------------------------------------------------------------------------
# Damped autoscaling: one switch per step change, no flapping
# --------------------------------------------------------------------------

def test_step_change_triggers_exactly_one_damped_switch(engine_case):
    # reference: test_step_change_triggers_exactly_one_damped_switch
    net, params, frontier, _dep = engine_case
    slow = min((c for c in frontier if c.kind == occam.PIPELINE),
               key=lambda c: (c.chips, -c.throughput))
    fast = max(frontier, key=lambda c: c.throughput)
    assert fast.throughput > slow.throughput

    async def drive():
        eng = occam.AsyncEngine(slow.deploy(device="cpu"), params,
                                max_wait_ms=25.0,
                                metrics_window_ms=600_000.0)
        eng.autoscale(frontier, band=0.25, windows=3)
        async with eng:
            x = _images(net, 3, 6)
            inflight = await eng.submit(x)
            high = fast.throughput * 0.99
            calm = slow.throughput * 0.9
            assert not any(eng.autoscale_step(rate=calm) for _ in range(6))
            for _ in range(2):
                assert not eng.autoscale_step(rate=high)
            assert not eng.autoscale_step(rate=calm)
            assert eng.reconcile_calls == 0
            hits = [eng.autoscale_step(rate=high) for _ in range(8)]
            assert hits.count(True) == 1
            assert eng.reconcile_calls == 1 and eng.switches == 1
            picked = eng.deployment.candidate
            assert picked is frontier.for_rate(high)
            assert picked is not slow and picked.throughput >= high
            assert eng.deployment.device == torch.device("cpu")
            assert not any(eng.autoscale_step(rate=high) for _ in range(6))
            assert eng.reconcile_calls == 1
            assert_close(await inflight, _ref(params, net, x))
            t2 = await eng.submit(x)
            assert_close(await t2, _ref(params, net, x))
            assert eng.compile_count == 1

    run(drive())


def test_switch_pipeline_to_single_and_back(engine_case):
    """A switch keeps an explicit ``round_batch`` only while the new
    geometry divides it (reference ``_switch``): from a pipeline
    candidate to a single-device one and back, and from a single-device
    engine at a round size no pipeline round divides. In-flight tickets
    resolve across every switch, and switching back reuses the cached
    deployment and its one tick build."""
    net, params, frontier, dep = engine_case
    width = dep.placement.steady_schedule().round_width
    assert width > 1
    low = min(c.throughput for c in frontier) * 1e-3
    high = max(c.throughput for c in frontier) * 10
    assert frontier.for_rate(low).kind == occam.SINGLE
    assert frontier.for_rate(high) is dep.candidate

    async def drive(start, round_batch, rates):
        eng = occam.AsyncEngine(start, params, round_batch=round_batch,
                                max_wait_ms=5.0,
                                metrics_window_ms=600_000.0)
        eng.autoscale(frontier, windows=1)
        seen, prev = [], None
        async with eng:
            for i, rate in enumerate((None,) + rates):
                if rate is not None:
                    # the previous ticket is still queued or in flight
                    assert eng.autoscale_step(rate=rate)
                x = _images(net, 3, 20 + i)
                t = await eng.submit(x)
                seen.append((eng.deployment.kind, eng.round_batch))
                if prev is not None:
                    assert_close(await prev[0], _ref(params, net, prev[1]))
                prev = (t, x)
                await asyncio.sleep(0)
            assert_close(await prev[0], _ref(params, net, prev[1]))
            assert eng.switches == len(rates)
            assert eng.compile_count == 1
        return seen

    rb = 2 * width
    assert run(drive(dep, rb, (low, high, low))) == [
        (occam.PIPELINE, rb), (occam.SINGLE, rb), (occam.PIPELINE, rb),
        (occam.SINGLE, rb)]
    single = frontier.for_rate(low).deploy(device="cpu")
    default = dep.placement.serve_geometry(None)[0]
    assert run(drive(single, width + 1, (high, low))) == [
        (occam.SINGLE, width + 1), (occam.PIPELINE, default),
        (occam.SINGLE, width + 1)]


def test_autoscale_requires_a_frontier(engine_case):
    # reference: test_autoscale_requires_a_frontier
    _net, params, _frontier, dep = engine_case
    bare = dep.candidate.placement().compile(device="cpu")
    eng = occam.AsyncEngine(bare, params)
    with pytest.raises(ValueError, match="frontier"):
        eng.autoscale()
    with pytest.raises(ValueError, match="armed"):
        eng.autoscale_step(rate=1.0)


# --------------------------------------------------------------------------
# Frontier.serve hand-off + Router
# --------------------------------------------------------------------------

def test_frontier_serve_and_router(engine_case):
    # reference: test_frontier_serve_and_router (device="cpu" passes
    # through Router.add to Frontier.serve)
    net, params, frontier, _dep = engine_case

    async def drive():
        router = Router()
        eng = router.add("vgg", frontier, params, objective="throughput",
                         device="cpu", max_wait_ms=25.0)
        assert eng.deployment.candidate is frontier.best("throughput")
        assert eng.deployment is frontier.best("throughput").deploy(
            device="cpu")
        assert eng.describe()["autoscale_armed"]
        other = occam.autoplan(net, occam.Fleet(chips=4,
                                                vmem_elems=CAPACITY),
                               batch=2)
        with pytest.raises(ValueError, match="fleet"):
            router.add("other", other, params, device="cpu")
        with pytest.raises(ValueError, match="already registered"):
            router.add("vgg", frontier, params, device="cpu")
        async with router:
            x = _images(net, 2, 7)
            t = await router.submit("vgg", x, tenant="alice")
            assert_close(await t, _ref(params, net, x))
            with pytest.raises(KeyError, match="unknown model"):
                await router.submit("nope", x)
            d = router.describe()
            assert d["models"] == ["vgg"]
            assert d["engines"]["vgg"]["compile_count"] == 1
            assert d["fleet"] == frontier.fleet.to_dict()

    run(drive())


# --------------------------------------------------------------------------
# Ticket cancellation
# --------------------------------------------------------------------------

def test_ticket_cancel_frees_budget_before_dispatch(engine_case):
    # reference: test_ticket_cancel_frees_budget_before_dispatch
    net, params, _frontier, dep = engine_case

    async def drive():
        eng = occam.AsyncEngine(dep, params, max_pending=2)
        async with eng:
            x1 = _images(net, 1, 3)
            t1 = await eng.submit(x1, tenant="fickle")
            t2 = await eng.submit(x1, tenant="fickle")
            with pytest.raises(occam.AdmissionError):
                await eng.submit(x1, tenant="fickle")
            assert t1.cancel() is True
            assert t1.cancelled() and t1.done()
            assert t1.cancel() is False
            with pytest.raises(asyncio.CancelledError):
                await t1
            t3 = await eng.submit(x1, tenant="fickle")
            await eng.drain()
            assert_close(await t2, _ref(params, net, x1))
            assert_close(await t3, _ref(params, net, x1))
            assert eng.queue.pending("fickle") == 0
            assert eng.describe()["cancellations"] == 1

    run(drive())


def test_ticket_cancel_in_flight_discards_and_settles(engine_case):
    # reference: test_ticket_cancel_in_flight_discards_and_settles
    net, params, _frontier, dep = engine_case

    async def drive():
        eng = occam.AsyncEngine(dep, params, max_pending=64)
        async with eng:
            xs = _images(net, eng.round_batch, 4)
            t = await eng.submit(xs, tenant="gone")
            for _ in range(50):
                await asyncio.sleep(0)
                if eng.describe()["rounds_in_flight"]:
                    break
            assert eng.describe()["rounds_in_flight"]
            t.cancel()
            with pytest.raises(asyncio.CancelledError):
                await t
            await eng.drain()
            assert eng.queue.pending("gone") == 0
            t2 = await eng.submit(xs, tenant="still-here")
            await eng.drain()
            assert_close(await t2, _ref(params, net, xs))

    run(drive())


# --------------------------------------------------------------------------
# The twin: the same submits under the same clock pack the same rounds
# --------------------------------------------------------------------------

# (tenant, images) submitted back to back in each phase; between phases
# the engine settles, and before phase 3 the fake clock passes the SLO
PHASES = [[("a", 3), ("b", 1), ("c", 5)],
          [("a", 2), ("b", 1), ("c", 2), ("a", 1)],
          [("b", 1), ("c", 3), ("a", 2)]]


async def _drive_twin(eng_cls, dep, params, images, as_input):
    """One engine through ``PHASES`` on a frozen clock: every round it
    dispatches as ``[(tenant, take), ...]`` and every ticket's output."""
    now = [0.0]
    eng = eng_cls(dep, params, round_batch=4, max_wait_ms=5.0,
                  clock=lambda: now[0])
    rounds = []
    dispatch = eng._dispatch

    def record(xs, segs, n_valid):
        rounds.append([(req.tenant, take) for req, take in segs])
        dispatch(xs, segs, n_valid)

    eng._dispatch = record

    async def settle():
        for _ in range(1000):
            await asyncio.sleep(0.001)
            if eng.queue.depth < eng.round_batch and eng._staged is None:
                return
        raise AssertionError("the engine did not settle")

    tickets, k = [], 0
    async with eng:
        for i, phase in enumerate(PHASES):
            if i == 2:
                # the queued partial ages past max_wait_ms and flushes
                now[0] += 0.010
                for _ in range(1000):
                    await asyncio.sleep(0.001)
                    if not eng.queue.depth:
                        break
                assert not eng.queue.depth
            for tenant, n in phase:
                tickets.append(await eng.submit(as_input(images[k:k + n]),
                                                tenant=tenant))
                k += n
            await settle()
        await eng.drain()
        outs = [np.asarray(await t) for t in tickets]
    return rounds, outs, eng.describe()


@pytest.mark.parametrize("out_rows", [1, 2])
@pytest.mark.parametrize("kind", ["single", "pipeline"])
def test_engine_packs_rounds_as_reference(kind, out_rows):
    """The port's engine and the reference's, on deployments of the same
    plan, packed by the same submit sequence under the same injected
    clock: the same rounds, with the same ``(tenant, take)`` segments in
    the same order (full rounds, an SLO-aged partial, the drain's
    partial), outputs within 1e-4 of each other and of the oracle."""
    net, j_net = _nets()
    params = _params(net)
    n = sum(n for phase in PHASES for _t, n in phase)
    images = _images(net, n, 30)
    plan = occam.plan(net, CAPACITY, out_rows=out_rows)
    j_plan = j_occam.plan(j_net, CAPACITY, out_rows=out_rows)
    assert plan.to_dict() == j_plan.to_dict()
    if kind == "single":
        dep = plan.place().compile(device="cpu")
        j_dep = j_plan.place().compile()
    else:
        require_devices(6)
        kw = dict(replicas=(1, 2, 1), microbatch=2)
        dep = plan.place(**kw).compile(device="cpu")
        j_dep = j_plan.place(**kw).compile()
    rounds, outs, desc = run(_drive_twin(occam.AsyncEngine, dep, params,
                                         images, lambda x: x))
    j_rounds, j_outs, j_desc = run(_drive_twin(
        j_occam.AsyncEngine, j_dep,
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        images, jnp.asarray))
    assert rounds == j_rounds
    assert rounds == [[("a", 3), ("b", 1)], [("c", 4)],
                      [("c", 1), ("a", 2), ("b", 1)], [("c", 2), ("a", 1)],
                      [("b", 1), ("c", 3)], [("a", 2)]]
    for key in ("packs_overlapped", "compile_count", "rejections"):
        assert desc[key] == j_desc[key], key
    assert desc["metrics"]["total_rounds"] == len(rounds)
    k = 0
    for y, j_y in zip(outs, j_outs):
        assert_close(y, j_y)
        assert_close(y, _ref(params, net, images[k:k + y.shape[0]]))
        k += y.shape[0]
    assert k == n

"""The serving path's in-memory spans (``repro_torch.occam.trace``) on the
CPU: off while no profiler records (one check, nothing kept, no
profiler range), and while ``torch.profiler`` records, each span a
record and a profiler range of the same interval, with its parent, on a
single-device session and engine. The engine's spans on a pipeline
deployment are tested beside its other tests
(``test_torch_async_engine.py``)."""
import asyncio
import gc
import statistics
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import occam
from repro_torch.core.graph import chain
from repro_torch.occam import trace

C, P = "conv", "pool"
LIMIT_S = 120.0


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def single():
    """A small net planned, placed and compiled on the CPU, one device."""
    net = chain("t", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 1, 1, 8)],
                in_h=8, in_w=8, in_ch=3)
    rng = np.random.default_rng(0)
    params = [{"w": rng.standard_normal((ly.k, ly.k, ly.in_ch, ly.out_ch),
                                        np.float32) * np.float32(0.2),
               "b": np.zeros(ly.out_ch, np.float32)} if ly.kind == C else {}
              for ly in net.layers]
    dep = occam.plan(net, 4000).place().compile(device="cpu")
    assert dep.kind == occam.SINGLE
    xs = torch.from_numpy(rng.standard_normal((9, 8, 8, 3), np.float32))
    return dep, params, xs


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _host_ranges(prof) -> dict[str, list[tuple[int, int]]]:
    out: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def assert_records_match_ranges(recs, prof):
    """Every span record has a profiler range of its name, taken in order,
    that holds it: the record's two clock reads lie inside the range's
    (within 10 µs, the profiler's conversion of its own clock), so the
    two are one interval. How far apart they lie is the profiler's own
    work between its clock read and the span's: about 1 µs a side at the
    median, 20 µs at most on an idle CPU, and a millisecond or more where
    the host deschedules the thread in between; the median stays under
    50 µs."""
    ranges = _host_ranges(prof)
    spans = sorted((r for r in recs if r.start_ns is not None),
                   key=lambda r: r.start_ns)
    assert spans
    taken: dict[str, int] = {}
    gaps = []
    for r in spans:
        i = taken.get(r.name, 0)
        taken[r.name] = i + 1
        start, end = ranges[r.name][i]
        assert start - 10_000 <= r.start_ns <= r.end_ns <= end + 10_000, r
        gaps += [r.start_ns - start, end - r.end_ns]
    assert all(len(ranges[n]) == k for n, k in taken.items())
    assert statistics.median(gaps) < 50_000


class _NoRange:
    """A profiler range standing in for torch's: any use fails."""

    def __init__(self, *a, **k):
        raise AssertionError("a span opened a profiler range")


def no_ranges(monkeypatch):
    """Make the span's range and ``record_function`` fail when used."""
    monkeypatch.setattr(trace, "_Range", _NoRange)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _NoRange)


def test_span_off_is_one_shared_object_and_allocates_nothing(monkeypatch):
    no_ranges(monkeypatch)
    assert not trace.enabled()
    sp = trace.span("occam.test")
    assert sp is trace.span("occam.other") and not sp

    def drive(names):
        for name in names:
            with trace.span(name) as s:
                if s:
                    s.set(x=1)
            trace.record(name)

    # once before the count: the interpreter's first pass over the loop
    # may keep a few bytes of its own
    drive(["occam.test"] * 10)
    names = ["occam.test"] * 10_000
    tracemalloc.start()
    try:
        before, _peak = tracemalloc.get_traced_memory()
        drive(names)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # one record or span object kept or made a call would take >= 56 B
    assert after == before and peak - before < 1024
    assert trace.records() == [] and trace.dropped() == 0


def test_span_on_records_parent_attrs_and_a_profiler_range():
    with _profile() as prof:
        with trace.span("occam.warm"):
            pass
        with trace.span("occam.outer", a=1) as outer:
            assert outer and trace.enabled()
            with trace.span("occam.inner") as inner:
                inner.set(b=2)
                trace.record("occam.point", c=3)
            outer.set(d=4)
    recs = {r.name: r for r in trace.records()}
    assert [r.name for r in trace.records()] == [
        "occam.warm", "occam.point", "occam.inner", "occam.outer"]
    out, inn, pt = recs["occam.outer"], recs["occam.inner"], \
        recs["occam.point"]
    assert (out.parent, inn.parent, pt.parent) == (0, out.id, inn.id)
    assert out.attrs == {"a": 1, "d": 4} and inn.attrs == {"b": 2}
    assert pt.attrs == {"c": 3} and pt.start_ns is pt.end_ns is None
    assert out.start_ns <= inn.start_ns <= inn.end_ns <= out.end_ns
    assert_records_match_ranges(trace.records(), prof)
    # the profiler stopped: spans are off again
    assert not trace.span("occam.after")


def test_kept_records_leave_the_garbage_collector():
    """Spans and records kept while the profiler records leave no object
    the cyclic collector counts: the objects a span makes die at its
    exit and the buffer keeps atomic values, so the collector's count of
    young objects, which paces every collection up to a full one (a
    pause of 0.1-0.3 s in a process holding torch), grows by the few
    objects made once, not by one or more a record."""
    def spans(n):
        for i in range(n):
            with trace.span("occam.s", ids=(i, i + 1)) as sp:
                sp.set(n=i, name="x", none=None, empty=())
                with trace.span("occam.inner"):
                    pass
            trace.record("occam.r", ids=(i,), ok=True)

    with _profile():
        spans(10)
        gc.collect()
        gc.disable()
        try:
            young = gc.get_count()[0]
            spans(1000)
            grown = gc.get_count()[0] - young
        finally:
            gc.enable()
    assert grown < 100          # 3,030 records kept
    assert trace._BUFFER.kept == 3030
    assert not any(gc.is_tracked(v) for v in trace._BUFFER.flat)
    recs = trace.records()
    assert len(recs) == 3030
    assert recs[1].attrs == {"ids": (0, 1), "n": 0, "name": "x",
                             "none": None, "empty": ()}
    assert recs[2].attrs == {"ids": (0,), "ok": True}
    assert recs[0].parent == recs[1].id and recs[2].parent == 0


def test_buffer_keeps_capacity_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(trace._BUFFER, "capacity", 3)
    with _profile():
        for _ in range(5):
            with trace.span("occam.s"):
                pass
    assert len(trace.records()) == 3 and trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_device_backlog_is_zero_off_the_gpu():
    backlog = trace.DeviceBacklog()
    backlog.mark(torch.device("cpu"))
    assert backlog.pending() == 0


def test_session_and_engine_off_keep_nothing(single, monkeypatch):
    """With no profiler, a session run and an engine run keep no record
    and open no profiler range."""
    dep, params, xs = single
    no_ranges(monkeypatch)
    with dep.serve(params, round_batch=4) as sess:
        sess.submit(xs[:5])
        assert len(sess.results()) == 1
        assert sess.timers.count == 2

    async def drive():
        eng = occam.AsyncEngine(dep, params, round_batch=4, max_wait_ms=1.0)
        async with eng:
            a = await eng.submit(xs[:1])
            b = await eng.submit(xs[:4])
            await a
            await b
            await eng.drain()

    asyncio.run(asyncio.wait_for(drive(), LIMIT_S))
    assert trace.records() == []


def test_session_spans_time_the_round_once(single):
    """``occam.session.submit`` around a submit, ``occam.session.round``
    around each round; the tick timer takes each round's duration from
    the span's own clock reads."""
    dep, params, xs = single
    with dep.serve(params, round_batch=2) as sess:
        with _profile() as prof:
            with trace.span("occam.warm"):
                pass
            t = sess.submit(xs[:5])
            sess.results()
        count, total = sess.timers.count, sess.timers.total_s
    recs = [r for r in trace.records() if r.name != "occam.warm"]
    sub = [r for r in recs if r.name == "occam.session.submit"]
    rounds = [r for r in recs if r.name == "occam.session.round"]
    assert len(sub) == 1 and sub[0].attrs == {"ticket": t.uid, "images": 5}
    # two full rounds inside submit, the masked remainder at results()
    assert [r.attrs["lanes"] for r in rounds] == [2, 2, 1]
    assert [r.attrs["tickets"] for r in rounds] == [(t.uid,)] * 3
    assert [r.parent for r in rounds] == [sub[0].id] * 2 + [0]
    assert count == 3
    assert total == pytest.approx(
        sum(r.end_ns - r.start_ns for r in rounds) / 1e9, abs=1e-9)
    assert_records_match_ranges(trace.records(), prof)


def test_single_device_engine_records_each_request(single):
    """On one device: a lone sub-round request leaves at the deadline, a
    round of two requests is full, and each request's record joins its
    stage, dispatch and deliver spans."""
    dep, params, xs = single

    async def drive():
        eng = occam.AsyncEngine(dep, params, round_batch=4, max_wait_ms=2.0)
        async with eng:
            await (await eng.submit(xs[:1]))
            with _profile() as prof:
                with trace.span("occam.warm"):
                    pass
                await (await eng.submit(xs[:1], tenant="a"))
                t1 = await eng.submit(xs[:3], tenant="b")
                t2 = await eng.submit(xs[:1], tenant="c")
                await t1
                await t2
            await eng.drain()
        return prof

    prof = asyncio.run(asyncio.wait_for(drive(), LIMIT_S))
    recs = trace.records()
    dispatch = [r for r in recs if r.name == "occam.engine.dispatch"]
    assert [(r.attrs["cause"], r.attrs["lanes"]) for r in dispatch] == \
        [("deadline", 1), ("full", 4)]
    assert all(r.attrs["device_backlog"] == 0 and
               r.attrs["round_batch"] == 4 for r in dispatch)
    reqs = [r for r in recs if r.name == "occam.engine.request"]
    assert [r.attrs["tenant"] for r in reqs] == ["a", "b", "c"]
    stage = [r for r in recs if r.name == "occam.engine.stage"]
    assert [r.attrs["requests"] for r in stage] == \
        [(reqs[0].attrs["request"],),
         (reqs[1].attrs["request"], reqs[2].attrs["request"])]
    assert all(r.attrs["bytes"] == 0 for r in stage)   # nothing to copy
    submits = [r for r in recs if r.name == "occam.engine.submit"]
    assert [r.attrs["admitted"] for r in submits] == [True] * 3
    assert [r.attrs["request"] for r in submits] == \
        [r.attrs["request"] for r in reqs]
    deliver = [r for r in recs if r.name == "occam.engine.deliver"]
    for rec in reqs:
        a = rec.attrs
        assert a["admitted_ns"] <= a["staged_ns"] <= a["resolved_ns"]
        assert not a["cancelled"]
        (d,) = [r for r in dispatch if a["request"] in r.attrs["requests"]]
        (v,) = [r for r in deliver if a["request"] in r.attrs["resolved"]]
        assert d.attrs["round"] in v.attrs["rounds"]
        assert a["resolved_ns"] == v.start_ns
    assert_records_match_ranges(recs, prof)

"""The readers of the program's spans: their arithmetic on synthetic
records, nothing (never 0) where the records hold nothing to read or too
few requests, nothing from a program that keeps no records, and numbers
from a traced run of the open and the closed loop on the CPU."""
import types

import pytest
import torch

from perfbench import bench, program, spans, spec
from perfbench.tests.conftest import tiny_cell

MS = 1_000_000
NEW = ["queue_wait_p95_ms.serve", "device_backlog.serve",
       "deadline_rounds.serve", "stage_host_ms.serve",
       "submit_host_ms.single"]


def rec(name, start=None, end=None, **attrs):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 attrs=attrs)


def request(wait_ms, admitted=0):
    return rec("occam.engine.request", admitted_ns=admitted,
               staged_ns=admitted + int(wait_ms * MS),
               resolved_ns=admitted + int(wait_ms * MS) + 5 * MS)


def dispatch(cause, lanes, backlog):
    return rec("occam.engine.dispatch", 0, MS, cause=cause, lanes=lanes,
               device_backlog=backlog)


def test_queue_wait_p95_over_requests_with_both_times():
    recs = [request(w) for w in range(1, 21)]       # waits 1..20 ms
    # the 95th percentile of 1..20 lies at 0.95 * 19 = 18.05 -> 19.05 ms
    assert spans.queue_wait_p95_ms(recs) == pytest.approx(19.05)
    # a request admitted before the profiler started has no admitted time
    unseen = rec("occam.engine.request", admitted_ns=None, staged_ns=5)
    assert spans.queue_wait_p95_ms(recs + [unseen]) == pytest.approx(19.05)


def test_queue_wait_needs_twenty_requests():
    assert spans.queue_wait_p95_ms([]) is None
    assert spans.queue_wait_p95_ms([request(1.0)] * 19) is None
    assert spans.queue_wait_p95_ms([request(0.0)] * 20) == 0.0


def test_dispatch_readers():
    recs = [dispatch("deadline", 1, 0), dispatch("deadline", 3, 2),
            dispatch("full", 8, 1), dispatch("lookahead", 8, 1),
            dispatch("deadline", 0, 5)]             # no lane: not a round
    assert spans.deadline_rounds(recs) == pytest.approx(50.0)
    assert spans.device_backlog(recs) == pytest.approx(9 / 5)
    assert spans.deadline_rounds([]) is None
    assert spans.device_backlog([]) is None
    assert spans.deadline_rounds([dispatch("drain", 0, 0)]) is None


def test_mean_ms_of_a_span():
    recs = [rec("occam.engine.stage", 0, 2 * MS),
            rec("occam.engine.stage", 10 * MS, 11 * MS),
            rec("occam.session.submit", 0, 7 * MS)]
    assert spans.mean_ms(recs, "occam.engine.stage") == pytest.approx(1.5)
    assert spans.mean_ms(recs, "occam.session.submit") == pytest.approx(7.0)
    assert spans.mean_ms(recs, "occam.engine.deliver") is None


def test_a_program_without_records_reads_nothing(monkeypatch):
    occam = types.SimpleNamespace()
    monkeypatch.setattr(program, "_import", lambda: (occam, None, None,
                                                     None))
    assert spans.records() == []
    for name in NEW:
        assert spec.reader(name)(None) is None
    kept = [request(2.0)] * 20 + [dispatch("deadline", 1, 1)]
    occam.trace = types.SimpleNamespace(records=lambda: kept)
    assert spec.reader("queue_wait_p95_ms.serve")(None) == \
        pytest.approx(2.0)
    assert spec.reader("deadline_rounds.serve")(None) == 100.0


@pytest.mark.parametrize("name,metrics", [
    ("resnet18-poisson", NEW[:4]), ("resnet18-single", NEW[4:])])
def test_a_traced_run_on_the_cpu_reads_numbers(name, metrics, one_thread):
    """The readers after a traced run of the cell's loop on the small
    net: every one a number (the device's backlog 0 on the CPU)."""
    program._import()[0].trace.clear()
    run = bench.run_cell(tiny_cell(name), 2**31 + 29, 1.0, trace=True,
                         device=torch.device("cpu"), t_start=bench.now(),
                         max_requests=24)
    assert run.correct
    table = spec.load()
    assert [m["name"] for m in spec.metrics_for(table, name, True)
            if m["name"] in NEW] == metrics
    for m in metrics:
        value = spec.reader(m)(run)
        assert isinstance(value, float) and value >= 0.0, (m, value)
    if name == "resnet18-poisson":
        assert spec.reader("device_backlog.serve")(run) == 0.0
    program._import()[0].trace.clear()

"""The profiler reader on a synthetic event list: busy and idle share,
compute time without copies, kernels counted, gaps named by the host op
at their middle; and the metric readers on its summary."""
import math

import pytest
import torch
from torch.autograd.profiler import record_function

from perfbench import bench, measures, profile_reader as pr, work
from perfbench.profile_reader import Event

MS = 1_000_000


def events():
    return [
        Event(pr.SLICE, "cpu", 0, 100 * MS, thread=1),
        Event("perfbench.submit", "cpu", 0, 30 * MS, thread=1),
        Event("aten::copy_", "cpu", 5 * MS, 25 * MS, thread=1),
        Event("perfbench.wait", "cpu", 60 * MS, 95 * MS, thread=1),
        # another thread's op never names a gap
        Event("cudaEventSynchronize", "cpu", 0, 100 * MS, thread=2),
        # a kernel that started before the slice: clipped, not counted
        Event("span_kernel", "kernel", -10 * MS, 10 * MS),
        Event("span_kernel", "kernel", 40 * MS, 50 * MS),
        Event("span_kernel", "kernel", 45 * MS, 55 * MS),
        Event("Memcpy DtoH (Device -> Pinned)", "copy", 55 * MS, 60 * MS),
        Event("span_kernel", "kernel", 90 * MS, 130 * MS),
    ]


def test_reduce_reads_busy_compute_and_gaps():
    t = pr.reduce(events())
    assert t.slice_s == pytest.approx(0.1)
    # busy: [0,10] + [40,60] + [90,100]
    assert t.busy_s == pytest.approx(0.040)
    assert t.idle_share == pytest.approx(0.6)
    # compute: [0,10] + [40,55] + [90,100], the copy left out
    assert t.compute_s == pytest.approx(0.035)
    assert t.compute_kernels == 3
    assert t.device_ops[0] == ["span_kernel", pytest.approx(0.040)]
    # gap [10,40]: middle 25 lies at the end of aten::copy_, inside submit;
    # gap [60,90]: inside the wait
    assert dict(t.idle_gaps) == {"perfbench.submit": pytest.approx(0.030),
                                 "perfbench.wait": pytest.approx(0.030)}


def test_reduce_reads_nothing_without_a_slice_or_device_events():
    assert pr.reduce(events()[1:]) is None
    assert pr.reduce([e for e in events() if e.kind == "cpu"]) is None


def test_events_from_a_profile_of_the_host():
    """The reader on a real profile: on the CPU every event is the host's,
    the harness's marker span among them, and a trace with no device event
    reduces to nothing."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with record_function(pr.SLICE):
        torch.ones(64).add_(1)
    prof.stop()
    evs = pr.events_from_profiler(prof)
    assert {e.kind for e in evs} == {"cpu"}
    marks = [e for e in evs if e.name == pr.SLICE]
    assert len(marks) == 1 and marks[0].end_ns > marks[0].start_ns
    assert any(e.name == "aten::add_" for e in evs)
    assert pr.reduce(evs) is None


def run_with(trace, images=100, rounds=10, failed=0):
    w = work.Work(flops_per_image=1e9, io_bytes_per_image=1e6,
                  weight_bytes=1e7)
    run = bench.Run(setup_s=9.0, window_s=20.0, attempted=100 + failed,
                    failed=failed,
                    images_done=2000, latencies_s=[i / 1e3 for i in range(1, 101)],
                    lateness_s=[], work=w, answers=[],
                    engine={"rounds": 10, "completions": 60,
                            "round_batch": 8})
    run.trace = trace
    run.slice = bench.Slice(images, rounds)
    return run


def test_readers_on_a_summary():
    t = pr.reduce(events())
    run = run_with(t)
    flops = 100 * 1e9
    assert measures.mfu_wall(run) == pytest.approx(
        100 * flops / (0.1 * work.PEAK_FLOPS))
    assert measures.mfu_busy(run) == pytest.approx(
        100 * flops / (0.040 * work.PEAK_FLOPS))
    assert measures.conv_roofline(run) == pytest.approx(
        100 * run.work.bound_s(100, 10) / 0.035)
    assert measures.device_idle(run) == pytest.approx(60.0)
    assert measures.kernels_per_image(run) == pytest.approx(0.03)
    assert measures.engine_occupancy(run) == pytest.approx(75.0)
    assert measures.images_per_s(run) == 100.0
    assert measures.p95_ms(run) == pytest.approx(95.05)


def test_readers_return_nothing_rather_than_zero():
    run = run_with(None)
    for f in (measures.mfu_wall, measures.mfu_busy, measures.conv_roofline,
              measures.device_idle, measures.kernels_per_image):
        assert f(run) is None
    run = run_with(pr.reduce(events()), images=0)
    assert measures.mfu_wall(run) is None
    assert measures.conv_roofline(run) is None


@pytest.mark.parametrize("failed, p95", [(0, 95.05), (1, 96.0), (5, 99.8),
                                         (6, math.inf)])
def test_failed_requests_count_as_infinitely_late(failed, p95):
    """A refused or unanswered request misses any latency limit: each one
    moves the tail up, and once 5% fail the tail is infinite."""
    run = run_with(None, failed=failed)
    assert measures.p95_ms(run) == pytest.approx(p95)


def test_percentile_agrees_with_statistics_on_finite_data():
    import statistics
    xs = [(i * 37 % 101) / 7 for i in range(57)]
    want = statistics.quantiles(xs, n=20, method="inclusive")[18]
    assert measures.percentile(xs, 0.95) == pytest.approx(want)

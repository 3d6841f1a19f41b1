"""Reduce a ``torch.profiler`` trace to what the per-layer metrics read.

The traced slice is the interval of the harness's own marker span
(``SLICE``), on the profiler's clock. Device events (kernels, copies,
memsets) are clipped to it. Nothing here knows the program: a kernel is
whatever ran on the device, whoever launched it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

SLICE = "perfbench.slice"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str           # "cpu", "kernel" or "copy"
    start_ns: int
    end_ns: int
    thread: int = 0


@dataclasses.dataclass(frozen=True)
class Trace:
    slice_s: float
    busy_s: float             # any kernel or copy running
    compute_s: float          # any kernel (not a copy) running
    compute_kernels: int      # kernels that started in the slice
    device_ops: list          # [[name, seconds], ...], most time first
    idle_gaps: list           # [[host op during the gap, seconds], ...]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.slice_s


def events_from_profiler(prof) -> list[Event]:
    """The profiler's raw events as :class:`Event` s. A device event is a
    copy (``Memcpy``/``Memset``) or a kernel, unless it is the device side
    of a user annotation, which carries the annotation's host name and
    covers work rather than doing any."""
    raw = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in raw if e.is_user_annotation()}
    out = []
    for e in raw:
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        name = e.name()
        if not str(e.device_type()).endswith("CUDA"):
            kind = "cpu"
        elif e.is_user_annotation() or name in annotations:
            continue
        else:
            kind = "copy" if name.startswith(("Memcpy", "Memset")) \
                else "kernel"
        out.append(Event(name, kind, start, end, e.start_thread_id()))
    return out


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _clip(events, lo, hi):
    return [(max(e.start_ns, lo), min(e.end_ns, hi)) for e in events
            if e.end_ns > lo and e.start_ns < hi]


def _host_op(cpu, starts, t: int) -> str:
    """The innermost host op running at ``t``: of those that contain it,
    the one that started last (``cpu`` sorted by start, ``starts`` their
    starts)."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if cpu[i].end_ns > t:
            return cpu[i].name
    return "host outside any op"


def reduce(events: list[Event]) -> Trace | None:
    """The slice's device summary, or None when the trace holds no slice
    marker or no device event inside it."""
    marks = [e for e in events if e.kind == "cpu" and e.name == SLICE]
    if not marks:
        return None
    mark = marks[0]
    lo, hi = mark.start_ns, mark.end_ns
    device = [e for e in events if e.kind != "cpu"
              and e.end_ns > lo and e.start_ns < hi]
    if not device:
        return None
    busy = _union(_clip(device, lo, hi))
    kernels = [e for e in device if e.kind == "kernel"]
    compute = _union(_clip(kernels, lo, hi))
    per_name: dict[str, int] = collections.Counter()
    for e in device:
        per_name[e.name] += min(e.end_ns, hi) - max(e.start_ns, lo)
    # the gaps between busy intervals, each named by what the host (the
    # thread that drew the slice) was doing at its middle
    cpu = [e for e in events if e.kind == "cpu" and e.thread == mark.thread
           and e.name != SLICE and e.end_ns > lo and e.start_ns < hi]
    cpu.sort(key=lambda e: (e.start_ns, -e.end_ns))
    starts = [e.start_ns for e in cpu]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps: dict[str, int] = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_op(cpu, starts, (a + b) // 2)] += b - a
    return Trace(
        slice_s=(hi - lo) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        compute_s=sum(b - a for a, b in compute) / 1e9,
        compute_kernels=sum(1 for e in kernels if lo <= e.start_ns < hi),
        device_ops=[[n[:160], t / 1e9] for n, t in per_name.most_common(TOP)],
        idle_gaps=[[n[:160], t / 1e9] for n, t in gaps.most_common(TOP)])

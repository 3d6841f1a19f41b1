"""The program's own spans of its serving path, as the per-layer metrics
read them.

The program (``repro_torch.occam.trace``) keeps a record of each span in
memory while ``torch.profiler`` records, so a ``--trace 1`` run holds the
spans of the profiled run: the window, the tail of answers after it, and
in the closed loops the one warm-up request of ``bench.Tracer.warm``. A
checkout whose program keeps no such records gives none, and every
reader then returns None. Each formula takes the records (objects with
``name``, ``start_ns``, ``end_ns`` and ``attrs``), so tests give it
synthetic ones.
"""
from __future__ import annotations

from perfbench import measures, program

MIN_REQUESTS = 20           # fewer give no 95th percentile
DISPATCH = "occam.engine.dispatch"
REQUEST = "occam.engine.request"


def records() -> list:
    """The records the program kept in this process; none where the
    program keeps no records."""
    recorder = getattr(program._import()[0], "trace", None)
    return list(recorder.records()) if recorder is not None else []


def _spans(recs, name: str) -> list:
    return [r for r in recs if r.name == name and r.start_ns is not None]


def queue_wait_p95_ms(recs) -> float | None:
    """The 95th percentile over requests of their wait in the engine's
    queue, admitted to their last image packed, in ms."""
    waits = [(r.attrs["staged_ns"] - r.attrs["admitted_ns"]) / 1e6
             for r in recs if r.name == REQUEST
             and r.attrs.get("admitted_ns") is not None
             and r.attrs.get("staged_ns") is not None]
    if len(waits) < MIN_REQUESTS:
        return None
    return measures.percentile(waits, 0.95)


def device_backlog(recs) -> float | None:
    """The mean number of rounds still on the device when the engine sent
    another."""
    backlog = [r.attrs["device_backlog"] for r in _spans(recs, DISPATCH)
               if r.attrs.get("device_backlog") is not None]
    return sum(backlog) / len(backlog) if backlog else None


def deadline_rounds(recs) -> float | None:
    """Rounds sent at the ``max_wait_ms`` deadline over every round that
    carried an image, in %."""
    sent = [r for r in _spans(recs, DISPATCH) if r.attrs.get("lanes", 0)]
    if not sent:
        return None
    late = sum(1 for r in sent if r.attrs.get("cause") == "deadline")
    return 100.0 * late / len(sent)


def mean_ms(recs, name: str) -> float | None:
    """The mean duration of the spans named ``name``, in ms."""
    spans = _spans(recs, name)
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / len(spans) / 1e6

"""Spans of the serving path, kept in memory while ``torch.profiler`` records.

The serving path's host layers mark their boundaries with :func:`span`.
While no profiler records (``torch.autograd._profiler_enabled()`` false)
a span is one check and a shared do-nothing object: no profiler range,
nothing allocated, nothing kept. While any ``torch.profiler`` session
records, a span opens a profiler range of its name (torch's C-level
``_RecordFunctionFast``, a few microseconds, where
``record_function`` takes about ten more), so the range lands in the
profiler's trace beside the device's kernels and names the device's idle
gaps, and keeps one record in a bounded buffer that :func:`records`
returns. No switch turns this on but the profiler itself; nothing here
writes a file (the profiler's own export holds the ranges).

To read the spans of a deployment: run it under any ``torch.profiler``
session, then call ``occam.trace.records()`` (``occam.trace.clear()``
empties the buffer). On the GPU the host's spans show what the host did;
a round's device time is in the profiler's device events, not in
``occam.session.round`` nor in ``TickTimers``, which time the host's
issue of a round.

A record's ``start_ns`` and ``end_ns`` are ``time.time_ns()``, the clock
of the profiler's host events, read just inside the profiler's range: a
record and its range are one interval, to the few microseconds the two
clock reads lie apart. :func:`record` keeps an in-memory record that is
no profiler range (a request's life crosses the serving loop's awaits,
and a range open across them would, as the innermost op, name the
device's idle gaps after a request instead of after what the loop does).

The buffer keeps its records flat, as atomic values in one list, so a
kept record is no object the cyclic garbage collector counts or tracks:
spans leave the collector's pace as it is without them (a full
collection pauses a process that holds torch for 0.1-0.3 s).

The spans, with their attributes:

* ``occam.engine.submit``: ``AsyncEngine.submit``, admission included;
  ``request``, ``tenant``, ``images``, ``queue_depth`` after, ``admitted``.
* ``occam.engine.wait.held``, ``occam.engine.wait.empty``: the serving
  loop asleep with images queued (toward the ``max_wait_ms`` deadline) or
  with none; ``queued``.
* ``occam.engine.stage``: ``_stage``, the pinned pack and the copy;
  ``images``, ``bytes`` copied from the host, ``requests``.
* ``occam.engine.dispatch``: ``_dispatch``; ``round`` (the session
  ticket), ``lanes``, ``round_batch``, ``cause`` (``full``, ``lookahead``,
  ``deadline`` or ``drain``), ``device_backlog``, ``requests``.
* ``occam.engine.deliver``: ``_deliver`` with rounds; ``rounds``,
  ``resolved``.
* ``occam.session.submit``: ``Session.submit``; ``ticket``, ``images``.
* ``occam.session.round``: a single-device round (copy in, padding,
  replay, clone); ``round``, ``lanes``, ``tickets``; per image lane of
  the round, ``boundary_bytes`` moved to and from device memory (the
  deployment's per-image transfer profile) and, where the round launches
  the fused-span kernel, ``weight_bytes`` staged into shared memory (the
  kernel's ``Counts`` of the round's launches). A STAP ring's tick:
  ``round``, ``valid_slots``.

and the record ``occam.engine.request``, one a request when its ticket
resolves or is cancelled (:func:`record_request`): ``request``,
``tenant``, ``images``, ``admitted_ns``, ``staged_ns`` (its last image
packed), ``resolved_ns``, ``cancelled``.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import time
from typing import NamedTuple

import torch

__all__ = ["CAPACITY", "DeviceBacklog", "Record", "clear", "dropped",
           "enabled", "now_ns", "record", "record_request", "records",
           "span", "timed"]

CAPACITY = 1 << 18          # records kept; later ones are counted, not kept

enabled = torch.autograd._profiler_enabled
now_ns = time.time_ns
# a profiler range that is no Python object the collector tracks
_Range = torch._C._profiler._RecordFunctionFast


class Record(NamedTuple):
    """One span (``start_ns``/``end_ns`` set) or one :func:`record`
    (both None). ``parent`` is the id of the span open around it in the
    same task or thread, 0 for none. Attribute values are numbers,
    strings, None or tuples of them."""

    name: str
    start_ns: int | None
    end_ns: int | None
    id: int
    parent: int
    attrs: dict


# marks a tuple in the flat buffer: its length and items follow
_SEQ = object()


class _Buffer:
    """Records laid end to end in one list: ``name, start_ns, end_ns, id,
    parent``, the number of attributes, then each attribute's name and
    value (a tuple as ``_SEQ``, its length, its items)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.flat: list = []
        self.kept = 0
        self.dropped = 0
        self.ids = itertools.count(1)

    def add(self, name, start_ns, end_ns, id_, parent, attrs: dict) -> None:
        if self.kept == self.capacity:
            self.dropped += 1
            return
        self.kept += 1
        flat = self.flat
        flat += (name, start_ns, end_ns, id_, parent, len(attrs))
        for key, value in attrs.items():
            if type(value) is tuple:
                flat += (key, _SEQ, len(value))
                flat += value
            else:
                flat += (key, value)


_BUFFER = _Buffer()
# the open span of the running task (each asyncio task has its own)
_OPEN: contextvars.ContextVar[int] = contextvars.ContextVar(
    "occam_trace_open_span", default=0)


def records() -> list[Record]:
    """The records kept so far, oldest end first."""
    flat, out, i = _BUFFER.flat, [], 0
    while i < len(flat):
        head, n = flat[i:i + 5], flat[i + 5]
        i += 6
        attrs = {}
        for _ in range(n):
            key, value = flat[i], flat[i + 1]
            i += 2
            if value is _SEQ:
                value = tuple(flat[i + 1:i + 1 + flat[i]])
                i += 1 + flat[i]
            attrs[key] = value
        out.append(Record(*head, attrs))
    return out


def dropped() -> int:
    """Records not kept because the buffer held :data:`CAPACITY`."""
    return _BUFFER.dropped


def clear() -> None:
    """Empty the buffer and its dropped count."""
    _BUFFER.flat.clear()
    _BUFFER.kept = _BUFFER.dropped = 0


class _Off:
    """The span while no profiler records: does nothing, is false."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns",
                 "_range", "_token", "_timers")

    def __init__(self, name: str, attrs: dict, timers=None):
        self.name = name
        self.attrs = attrs
        self._timers = timers

    def __enter__(self) -> "_Span":
        self.id = next(_BUFFER.ids)
        self.parent = _OPEN.get()
        self._token = _OPEN.set(self.id)
        self._range = _Range(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _OPEN.reset(self._token)
        _BUFFER.add(self.name, self.start_ns, self.end_ns, self.id,
                    self.parent, self.attrs)
        if self._timers is not None:
            self._timers.record((self.end_ns - self.start_ns) / 1e9)
        return False

    def set(self, **attrs) -> None:
        """Add attributes (numbers, strings, None or tuples of them); call
        sites guard costly ones with ``if sp:``."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """Context manager: a profiler range and an in-memory record named
    ``name`` while a profiler records; else a false object that does
    nothing. ``as sp`` gives the span; ``sp.set(**attrs)`` adds
    attributes."""
    if not enabled():
        return _OFF
    return _Span(name, attrs)


class _Timed:
    """``timers.time()`` while no profiler records; the span is ``_OFF``."""

    __slots__ = ("_tick",)

    def __init__(self, timers):
        self._tick = timers.time()

    def __enter__(self) -> _Off:
        self._tick.__enter__()
        return _OFF

    def __exit__(self, *exc) -> bool:
        return self._tick.__exit__(*exc)


def timed(name: str, timers):
    """:func:`span` around a serving tick whose duration also goes to
    ``timers`` (a :class:`~repro_torch.occam.TickTimers`) from the span's
    own two clock reads, so the tick is not timed twice; while no
    profiler records, ``timers.time()`` alone."""
    if not enabled():
        return _Timed(timers)
    return _Span(name, {}, timers)


def record(name: str, **fields) -> None:
    """Keep one in-memory record that is no profiler range (only while a
    profiler records; ``fields`` become its ``attrs``)."""
    if enabled():
        _BUFFER.add(name, None, None, next(_BUFFER.ids), _OPEN.get(),
                    fields)


def record_request(req, resolved_ns: int, cancelled: bool) -> None:
    """Keep ``occam.engine.request`` for an engine's request (a
    ``serve.queue.Request``) that resolved or was cancelled at
    ``resolved_ns``."""
    record("occam.engine.request", request=req.uid, tenant=req.tenant,
           images=req.n, admitted_ns=req.admitted_ns,
           staged_ns=req.staged_ns, resolved_ns=resolved_ns,
           cancelled=cancelled)


class DeviceBacklog:
    """Rounds issued to a GPU whose completion has not been seen: one CUDA
    event (timing off) is recorded after each round on the device's
    current stream and queried, never waited on, at the next. Rounds on
    the CPU complete when issued."""

    def __init__(self):
        self._events: collections.deque = collections.deque()

    def pending(self) -> int:
        """Rounds marked earlier whose event has not fired (events on one
        stream fire in order)."""
        events = self._events
        while events and events[0].query():
            events.popleft()
        return len(events)

    def mark(self, device: torch.device) -> None:
        """Note the end of the round just issued on ``device``."""
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            self._events.append(ev)

"""Wall-clock observability for the serving runtime.

:class:`TickTimers` is a windowed, always-on dispatch timer the serving
session threads through every tick; it feeds the ``timing`` block of
``Session.report()``. Deliberately cheap: one clock read per tick, a
bounded deque, no device synchronization. The classes are the reference
package's, copied unchanged; the synchronized stage micro-measurements
that fit a cost model belong to the calibration slice of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class TickTimers:
    """Windowed wall-clock accumulator for serving ticks.

    ``record(seconds)`` stamps one completed tick; events older than
    ``horizon_s`` roll off. ``busy_fraction()`` is the fraction of the
    observed window spent inside timed ticks — the duty cycle the
    utilization stats scale per-stage shares by."""

    horizon_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    events: collections.deque = dataclasses.field(
        default_factory=collections.deque)   # (t_end, duration_s)
    total_s: float = 0.0     # lifetime, never rolls off
    count: int = 0

    def record(self, duration_s: float) -> None:
        now = self.clock()
        self.events.append((now, float(duration_s)))
        self.total_s += float(duration_s)
        self.count += 1
        self._roll(now)

    def time(self):
        """Context manager: ``with timers.time(): <one tick>``."""
        return _TimerContext(self)

    def _roll(self, now: float) -> None:
        while self.events and self.events[0][0] < now - self.horizon_s:
            self.events.popleft()

    def window(self, now: float | None = None) -> tuple[int, float]:
        """(ticks, busy seconds) inside the rolling horizon."""
        now = self.clock() if now is None else now
        self._roll(now)
        return len(self.events), sum(d for (_t, d) in self.events)

    def mean_s(self, now: float | None = None) -> float:
        n, busy = self.window(now)
        return busy / n if n else 0.0

    def busy_fraction(self, now: float | None = None) -> float:
        """Busy seconds / observed span, over the rolling window."""
        now = self.clock() if now is None else now
        n, busy = self.window(now)
        if not n:
            return 0.0
        start = self.events[0][0] - self.events[0][1]
        span = max(now - start, busy, 1e-12)
        return min(busy / span, 1.0)


class _TimerContext:
    def __init__(self, timers: TickTimers):
        self.timers = timers

    def __enter__(self):
        self._t0 = self.timers.clock()
        return self

    def __exit__(self, *exc):
        self.timers.record(self.timers.clock() - self._t0)
        return False

"""Live serving metrics: a ring of fixed-width wall-clock windows.

The async engine observes its own traffic — request arrivals, queue
depth, round occupancy (valid lanes / round lanes), and per-ticket
latency — into an open window; :meth:`MetricsRing.roll` closes windows
as wall-clock time passes them and returns the newly closed ones, so
the autoscaling loop runs on *observations per window*, never on
instantaneous spikes. The ring keeps the last ``windows`` closed
windows (older ones fall off), which bounds memory however long the
engine serves.

Everything takes an injectable ``clock`` (default
``time.monotonic``) so tests and the damped autoscaler drive window
boundaries deterministically.
"""
from __future__ import annotations

import collections
import dataclasses
import time


def percentile(samples, q: float) -> float | None:
    """The q-th percentile (0..100) by linear interpolation between
    order statistics — ``None`` on no samples. Small-sample exact (the
    latency rings hold at most a few hundred tickets)."""
    if not samples:
        return None
    xs = sorted(samples)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


@dataclasses.dataclass
class Window:
    """One closed (or still-open) observation window."""

    start: float
    duration: float                      # seconds this window spans
    arrivals: int = 0                    # images submitted
    completions: int = 0                 # images delivered
    rounds: int = 0                      # device ticks carrying >= 1 lane
    valid_lanes: int = 0                 # occupied lanes across those rounds
    round_lanes: int = 0                 # total lanes across those rounds
    queue_depth_last: int = 0            # gauge at last observation

    @property
    def arrival_rate(self) -> float:
        """Images/s submitted during this window."""
        return self.arrivals / self.duration if self.duration > 0 else 0.0

    @property
    def occupancy(self) -> float | None:
        """Valid lanes / total lanes over this window's rounds (1.0 =
        every served round was full; ``None`` when no round ran)."""
        if not self.round_lanes:
            return None
        return self.valid_lanes / self.round_lanes


class MetricsRing:
    """The engine's metrics surface: observations land in the open
    window; :meth:`roll` closes windows on the wall clock. Snapshots
    aggregate the closed ring (plus the open window for gauges)."""

    def __init__(self, *, window_s: float = 0.1, windows: int = 64,
                 latency_samples: int = 512, clock=time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if windows < 1:
            raise ValueError("windows must be >= 1")
        self.window_s = float(window_s)
        self.clock = clock
        self._closed: collections.deque[Window] = collections.deque(
            maxlen=windows)
        self._latencies: collections.deque = collections.deque(
            maxlen=latency_samples)
        self._open = Window(start=clock(), duration=self.window_s)
        # lifetime totals (never windowed away)
        self.total_arrivals = 0
        self.total_completions = 0
        self.total_rounds = 0

    # -- observations (land in the open window) -----------------------------

    def observe_arrival(self, images: int, queue_depth: int | None = None
                        ) -> None:
        self._open.arrivals += images
        self.total_arrivals += images
        if queue_depth is not None:
            self._open.queue_depth_last = queue_depth

    def observe_round(self, valid_lanes: int, round_lanes: int) -> None:
        """One device tick that carried traffic: its lane occupancy."""
        self._open.rounds += 1
        self._open.valid_lanes += valid_lanes
        self._open.round_lanes += round_lanes
        self.total_rounds += 1

    def observe_completion(self, images: int, latency_s: float) -> None:
        self._open.completions += images
        self.total_completions += images
        self._latencies.append(latency_s)

    def observe_queue_depth(self, depth: int) -> None:
        self._open.queue_depth_last = depth

    # -- windowing -----------------------------------------------------------

    def roll(self, now: float | None = None) -> list[Window]:
        """Close every window the clock has passed; return them oldest
        first (empty list while the open window is still current). Idle
        gaps close as zero-arrival windows — a silent engine *observes*
        silence, which is what lets the autoscaler scale down."""
        now = self.clock() if now is None else now
        # a long idle gap would close thousands of empty windows one by
        # one; only the last ``maxlen`` survive the ring anyway, so skip
        # the open window straight to the tail of the gap first
        maxlen = self._closed.maxlen or 1
        gap = now - self._open.start
        if gap >= self.window_s * (maxlen + 1):
            skipped = int(gap // self.window_s) - maxlen
            self._open.start += skipped * self.window_s
        closed: list[Window] = []
        while now - self._open.start >= self.window_s:
            w = self._open
            w.duration = self.window_s
            closed.append(w)
            self._closed.append(w)
            self._open = Window(start=w.start + self.window_s,
                                duration=self.window_s,
                                queue_depth_last=w.queue_depth_last)
        return closed

    @property
    def closed_windows(self) -> tuple[Window, ...]:
        return tuple(self._closed)

    def arrival_rate(self, windows: int | None = None) -> float:
        """Mean images/s over the most recent ``windows`` closed windows
        (default: everything the ring holds; 0.0 before any window
        closes)."""
        ws = list(self._closed)
        if windows is not None:
            ws = ws[-windows:]
        if not ws:
            return 0.0
        span = sum(w.duration for w in ws)
        return sum(w.arrivals for w in ws) / span if span > 0 else 0.0

    # -- aggregate view ------------------------------------------------------

    def snapshot(self) -> dict:
        """Machine-readable aggregate of the ring: rates, depth,
        occupancy, latency percentiles (p50/p99 over the recent-ticket
        latency ring)."""
        ws = list(self._closed)
        lanes = sum(w.round_lanes for w in ws)
        valid = sum(w.valid_lanes for w in ws)
        return {
            "window_s": self.window_s,
            "windows_closed": len(ws),
            "arrival_rate": self.arrival_rate(),
            "queue_depth": self._open.queue_depth_last,
            "round_occupancy": (valid / lanes) if lanes else None,
            "latency_p50_s": percentile(self._latencies, 50.0),
            "latency_p99_s": percentile(self._latencies, 99.0),
            "total_arrivals": self.total_arrivals,
            "total_completions": self.total_completions,
            "total_rounds": self.total_rounds,
        }

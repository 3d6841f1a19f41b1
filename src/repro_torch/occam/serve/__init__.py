"""``occam.serve`` — async continuous batching over compiled Sessions.

The subsystem ROADMAP item 1 names: a vLLM-lineage engine (cf. the
aphrodite ``AsyncEngine`` / ``model_runner`` split) layered on the ONE
compiled fixed-shape tick a :class:`~repro.occam.Session` wraps. The
layers, bottom up:

* :mod:`.queue` — :class:`AdmissionQueue`: per-tenant ``max_pending``
  backpressure (:class:`AdmissionError`) in front of a FIFO packer that
  splits requests across fixed-shape round boundaries.
* :mod:`.metrics` — :class:`MetricsRing`: arrival rate, queue depth,
  round occupancy, p50/p99 ticket latency in a ring of wall-clock
  windows; the damped autoscaler's observation surface.
* :mod:`.engine` — :class:`AsyncEngine`: ``await submit(images,
  tenant=...)`` tickets, wall-clock ``max_wait_ms`` SLO flushes,
  host-side packing double-buffered against device ticks, and
  hysteresis-damped ``Deployment.reconcile`` autoscaling. Adds ZERO
  lowerings over a bare session.
* :mod:`.router` — :class:`Router`: several nets' frontiers over one
  shared fleet, dispatched by model id.

Entry points: ``Frontier.serve(params)`` (plan -> engine in one call)
or ``AsyncEngine(deployment, params)`` directly.
"""
from .engine import AsyncEngine, AsyncTicket
from .metrics import MetricsRing, Window, percentile
from .queue import AdmissionError, AdmissionQueue, Request
from .router import Router

__all__ = [
    "AsyncEngine",
    "AsyncTicket",
    "AdmissionError",
    "AdmissionQueue",
    "Request",
    "MetricsRing",
    "Window",
    "percentile",
    "Router",
]

"""Occam's core planning modules (paper §III), copied from ``repro.core``.

`closure` — row-plane tiles + dependence-closure arithmetic and the
static span schedules; `partition` — the optimal-partition DP; `traffic`
— analytical traffic models and the shared TrafficCounter; `graph` — the
NetSpec; `stap` — the STAP replication planner and its tick schedules.
"""
from . import closure, graph, partition, stap, traffic  # noqa: F401

__all__ = ["closure", "graph", "partition", "stap", "traffic"]

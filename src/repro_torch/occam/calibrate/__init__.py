"""``occam.calibrate`` — measured-cost planning (paper §III-D/E closed
into a loop).

``autoplan`` ranks candidates with an analytic MAC/byte model; real
systems plan on measurements. This package turns a running deployment
into a cost model and the cost model back into a better frontier:

* :mod:`timers` — the serving tick timer, per-stage measurement (CUDA
  events on the GPU), exported as a JSON-shippable
  :class:`StageProfile`.
* :mod:`cost_model` — ``calibrate(deployment, params) -> CostModel``:
  fits the compute affine model (rate and per-stage overhead) over the
  analytic one, persisted alongside plans (schema-v4 ``calibration``
  block).
* :mod:`rescore` — ``Frontier.rescore(cost_model)``: re-rank every
  candidate's steady period / fill latency from measured costs without
  re-running the DP; deploy caches survive.
* :mod:`placement` — sum-of-replicas chip packing (§III-E STAP is truly
  asynchronous: a 4-3-2 plan occupies 9 chips, not a rectangular 12).
"""
from .cost_model import CostModel, calibrate
from .placement import ChipAssignment, pack_replicas
from .rescore import rescore_frontier
from .timers import StageProfile, TickTimers, measure_stage_seconds

__all__ = [
    "ChipAssignment", "CostModel", "StageProfile", "TickTimers",
    "calibrate", "measure_stage_seconds", "pack_replicas",
    "rescore_frontier",
]

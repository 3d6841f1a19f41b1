"""Fitting measured costs over the analytic model (``occam.calibrate``).

``autoplan`` scores candidates with analytic rates — MACs over
``Fleet.macs_per_s``, link payloads over ``link_elems_per_s`` — the
same first-order roofline as ``repro.core.traffic.MachineModel``. Real
stages carry overheads those rates cannot see (dispatch, padding,
engine constants). :func:`calibrate` measures a deployment's stage
bodies and boundary hops in isolation (``calibrate.timers``) and fits a
:class:`CostModel`: an affine per-stage compute model ``t = macs /
macs_per_s + overhead`` plus measured link/HBM rates. The model is
JSON-shippable and persists alongside plans (the schema-v4 optional
``calibration`` block); ``Frontier.rescore`` re-ranks every candidate
under it without re-running the DP.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

CALIBRATION_VERSION = 1


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Measured per-arch cost rates.

    ``macs_per_s`` / ``stage_overhead_s`` are the affine fit over the
    (analytic MACs, measured seconds) stage pairs; ``link_s_per_elem``
    converts boundary payload elements to hop seconds (0.0 = no links
    measured); ``hbm_elems_per_s`` optionally floors single-chip periods
    the way ``Fleet.hbm_elems_per_s`` does. ``analytic_macs_per_s``
    records the rate the fit was taken against, so
    ``compute_overhead_factor`` exposes how far the machine sits from
    the analytic roofline."""

    macs_per_s: float
    stage_overhead_s: float = 0.0
    link_s_per_elem: float = 0.0
    hbm_elems_per_s: float | None = None
    analytic_macs_per_s: float | None = None
    samples: int = 0
    residual: float = 0.0    # rms relative error of the fit

    def __post_init__(self) -> None:
        if self.macs_per_s <= 0:
            raise ValueError("macs_per_s must be positive")
        if self.stage_overhead_s < 0 or self.link_s_per_elem < 0:
            raise ValueError("overheads must be non-negative")

    @property
    def compute_overhead_factor(self) -> float:
        """Analytic rate / fitted rate: >1 means the machine is slower
        than the roofline the frontier was scored with."""
        if not self.analytic_macs_per_s:
            return 1.0
        return self.analytic_macs_per_s / self.macs_per_s

    def stage_seconds(self, macs: float) -> float:
        return float(macs) / self.macs_per_s + self.stage_overhead_s

    def hop_seconds(self, elems: float) -> float:
        return float(elems) * self.link_s_per_elem

    def hbm_seconds(self, elems: float) -> float:
        if not self.hbm_elems_per_s:
            return 0.0
        return float(elems) / self.hbm_elems_per_s

    def to_dict(self) -> dict:
        return {
            "version": CALIBRATION_VERSION,
            "macs_per_s": self.macs_per_s,
            "stage_overhead_s": self.stage_overhead_s,
            "link_s_per_elem": self.link_s_per_elem,
            "hbm_elems_per_s": self.hbm_elems_per_s,
            "analytic_macs_per_s": self.analytic_macs_per_s,
            "samples": self.samples,
            "residual": self.residual,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        v = d.get("version", CALIBRATION_VERSION)
        if v > CALIBRATION_VERSION:
            raise ValueError(f"calibration block version {v} is newer than "
                             f"supported {CALIBRATION_VERSION}")
        return cls(
            macs_per_s=float(d["macs_per_s"]),
            stage_overhead_s=float(d.get("stage_overhead_s", 0.0)),
            link_s_per_elem=float(d.get("link_s_per_elem", 0.0)),
            hbm_elems_per_s=d.get("hbm_elems_per_s"),
            analytic_macs_per_s=d.get("analytic_macs_per_s"),
            samples=int(d.get("samples", 0)),
            residual=float(d.get("residual", 0.0)),
        )


def fit_cost_model(stage_macs: Sequence[float],
                   stage_seconds: Sequence[float], *,
                   hop_seconds: float = 0.0,
                   hop_elems: float = 0.0,
                   hbm_elems_per_s: float | None = None,
                   analytic_macs_per_s: float | None = None) -> CostModel:
    """Least-squares affine fit ``t = macs / macs_per_s + overhead`` over
    the per-stage (analytic MACs, measured seconds) pairs, plus the
    measured link rate from one hop measurement."""
    ms = [float(m) for m in stage_macs]
    ts = [float(t) for t in stage_seconds]
    if len(ms) != len(ts) or not ms:
        raise ValueError("need equal, non-empty stage_macs/stage_seconds")
    if any(m <= 0 for m in ms) or any(t <= 0 for t in ts):
        raise ValueError("stage MACs and seconds must be positive")
    n = len(ms)
    mean_m = sum(ms) / n
    mean_t = sum(ts) / n
    var_m = sum((m - mean_m) ** 2 for m in ms)
    if n >= 2 and var_m > 0:
        slope = sum((m - mean_m) * (t - mean_t)
                    for m, t in zip(ms, ts)) / var_m
        intercept = mean_t - slope * mean_m
        if slope <= 0 or intercept < 0:
            # degenerate fit (noise dominates): fall back to the
            # zero-overhead rate through the means
            slope, intercept = mean_t / mean_m, 0.0
    else:
        slope, intercept = mean_t / mean_m, 0.0
    rate = 1.0 / slope
    resid = (sum(((slope * m + intercept - t) / t) ** 2
                 for m, t in zip(ms, ts)) / n) ** 0.5
    link = hop_seconds / hop_elems if hop_elems > 0 and hop_seconds > 0 \
        else 0.0
    return CostModel(macs_per_s=rate, stage_overhead_s=intercept,
                     link_s_per_elem=link, hbm_elems_per_s=hbm_elems_per_s,
                     analytic_macs_per_s=analytic_macs_per_s, samples=n,
                     residual=resid)


def calibrate(deployment, params, *, rounds: int = 3,
              fleet=None) -> CostModel:
    """Measure ``deployment``'s stages and fit a :class:`CostModel`.

    ``rounds`` is the number of synchronized timing repetitions per
    stage body. ``fleet`` supplies the analytic rates the fit is
    recorded against (defaults to the fleet of the frontier this
    deployment was deployed from, else the module default rate). The
    returned model feeds ``Frontier.rescore`` and persists in the plan's
    schema-v4 ``calibration`` block.
    """
    profile = deployment.profile(params, iters=rounds)
    if fleet is None and getattr(deployment, "frontier", None) is not None:
        fleet = deployment.frontier.fleet
    if fleet is not None:
        analytic = fleet.macs_per_s
        hbm = fleet.hbm_elems_per_s
    else:
        from repro_torch.occam.fleet import DEFAULT_MACS_PER_S
        analytic, hbm = DEFAULT_MACS_PER_S, None
    # the hop measurement moved one (microbatch, payload_width) slot;
    # per image that is ~the widest boundary payload
    return fit_cost_model(
        profile.stage_macs,
        [t / max(profile.microbatch, 1) for t in profile.stage_seconds],
        hop_seconds=profile.hop_seconds / max(profile.microbatch, 1),
        hop_elems=max(profile.payload_elems, default=0),
        hbm_elems_per_s=hbm,
        analytic_macs_per_s=analytic)

"""Stage 2 of the deployment API: ``Plan.place(...)`` -> :class:`Placement`.

A Placement binds a :class:`~repro_torch.occam.Plan` to hardware. This
package has the single-device placement so far (all spans in sequence on
one device — the paper's single-inference slice); the STAP pipeline
placement (``PIPELINE``) arrives with the multi-chip slice of the port.
Planning already scores pipeline candidates (``occam.autoplan``); placing
one raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import torch

from .plan import Plan

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .deploy import Deployment

SINGLE = "single"
PIPELINE = "pipeline"

_STAP_SLICE = ("multi-chip placements (chips/replicas/stage_times/"
               "target_period/max_replicas/mesh/devices/pipeline=True) run "
               "in the STAP pipeline slice of the port, which has not "
               "landed; call place() with no multi-chip argument")


@dataclasses.dataclass
class Placement:
    plan: Plan
    kind: str          # SINGLE
    microbatch: int    # images per execution slot
    # device layout of a pipeline's serving ring ("rect" or "sum"); a
    # single-device placement keeps the default
    packing: str = "rect"

    @property
    def chips(self) -> int:
        """Chips the plan accounts for: one for the single-device
        placement."""
        return 1

    @property
    def replicas(self) -> tuple[int, ...]:
        return (1,)

    @property
    def ring_depth(self) -> int:
        """Rounds resident in the serving ring — submit-to-result latency
        in ticks (1 for the single-device placement)."""
        return 1

    def serve_geometry(self, round_batch: int | None = None
                       ) -> tuple[int, int]:
        """Size one serving round: ``(round_batch, microbatch)``.

        Single-device rounds have width 1, so any positive
        ``round_batch`` works and the microbatch is the whole round.
        Default: the plan's recorded serving default, else the placement
        microbatch.
        """
        if round_batch is None:
            round_batch = self.plan.serving.round_batch
        if round_batch is None:
            round_batch = self.microbatch
        round_batch = int(round_batch)
        if round_batch < 1:
            raise ValueError(f"round_batch must be positive (single-device "
                             f"rounds have width 1), got {round_batch}")
        return round_batch, round_batch

    def compile(self, backend: str = "auto", *,
                device: str | torch.device | None = None) -> "Deployment":
        """Stage 3: lower onto engines -> :class:`~repro_torch.occam
        .Deployment`.

        ``backend``: ``"auto"`` or any registered engine name (forced for
        every span). ``device``: where the deployment runs; ``None`` means
        the GPU (``"cuda"``), and raises when no GPU is visible — pass
        ``device="cpu"`` to run on the CPU.
        """
        from .deploy import Deployment

        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Placement.compile() runs on the GPU by default, and no "
                    "CUDA device is visible; pass device=\"cpu\" to run on "
                    "the CPU")
            device = "cuda"
        return Deployment(self, backend=backend, device=torch.device(device))


def place_plan(plan: Plan, *, chips: int | None = None,
               replicas: Sequence[int] | None = None,
               stage_times: Sequence[float] | None = None,
               target_period: float | None = None,
               max_replicas: int | None = None,
               microbatch: int | None = None,
               mesh=None, devices=None,
               pipeline: bool | None = None,
               packing: str = "rect") -> Placement:
    """Implementation of :meth:`Plan.place` (see its docstring)."""
    if packing not in ("rect", "sum"):
        raise ValueError(f"packing must be 'rect' or 'sum', got {packing!r}")
    multichip_args = (chips, replicas, stage_times, target_period,
                      max_replicas, mesh, devices)
    if pipeline or any(a is not None for a in multichip_args):
        raise NotImplementedError(_STAP_SLICE)
    if packing == "sum":
        raise ValueError("packing='sum' applies to pipeline "
                         "placements only")
    microbatch = microbatch if microbatch is not None else plan.batch
    return Placement(plan, SINGLE, microbatch)

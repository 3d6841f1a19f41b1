"""Sum-of-replicas chip packing for STAP pipelines (paper §III-E).

STAP stages are asynchronous — replica ``m % r_i`` of stage i serves
mini-batch m with no clock edges between stages — so a 4-3-2 plan needs
exactly 4 + 3 + 2 = 9 chips. The first SPMD executable realized the
schedule on a rectangular (stage, max_replicas) device mesh, padding
every stage to the widest one: the same plan occupied 3 x 4 = 12 chips,
with 3 of them permanently idle. This module owns the *packed* device
layout: a flat chip axis of exactly ``sum(replicas)`` devices, chips
assigned to stages contiguously.

:class:`ChipAssignment` is pure geometry (no JAX): the stage<->chip
maps, the per-slot ownership table, and the per-slot inter-stage routing
that :class:`repro.runtime.stap_pipeline.StapRing` compiles into its
packed single-tick step. ``pack_replicas`` is the packer entry point
used by ``Placement`` / ``Fleet`` budget accounting.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.core.stap import SteadySchedule


@dataclasses.dataclass(frozen=True)
class ChipAssignment:
    """Contiguous packing of stage replicas onto a flat chip axis.

    Stage i owns chips ``offsets[i] .. offsets[i] + replicas[i] - 1``;
    replica j of stage i lives on chip ``offsets[i] + j``. Total chips =
    ``sum(replicas)`` — the paper's §III-E accounting — versus the
    rectangular mesh's ``n_stages * max(replicas)``.
    """

    replicas: tuple[int, ...]

    def __post_init__(self) -> None:
        if not self.replicas:
            raise ValueError("need at least one stage")
        if any(r < 1 for r in self.replicas):
            raise ValueError(f"replica counts must be >= 1: {self.replicas}")

    @property
    def n_stages(self) -> int:
        return len(self.replicas)

    @property
    def n_chips(self) -> int:
        """Packed chip count: the sum of replicas."""
        return sum(self.replicas)

    @property
    def rect_chips(self) -> int:
        """What the rectangular (stage, replica) mesh would occupy."""
        return self.n_stages * max(self.replicas)

    @property
    def chips_saved(self) -> int:
        return self.rect_chips - self.n_chips

    @property
    def offsets(self) -> tuple[int, ...]:
        """First chip of each stage (prefix sums of ``replicas``)."""
        return tuple(itertools.accumulate((0,) + self.replicas[:-1]))

    def chip_of(self, stage: int, replica: int) -> int:
        if not 0 <= replica < self.replicas[stage]:
            raise ValueError(
                f"stage {stage} has {self.replicas[stage]} replicas, "
                f"no replica {replica}")
        return self.offsets[stage] + replica

    def stage_of(self, chip: int) -> int:
        if not 0 <= chip < self.n_chips:
            raise ValueError(f"chip {chip} out of range 0..{self.n_chips - 1}")
        offs = self.offsets
        for i in range(self.n_stages - 1, -1, -1):
            if chip >= offs[i]:
                return i
        raise AssertionError("unreachable")

    def stage_ids(self) -> tuple[int, ...]:
        """Per-chip stage index — the lookup table the packed SPMD tick
        uses to pick its span body from ``lax.axis_index``."""
        return tuple(i for i, r in enumerate(self.replicas) for _ in range(r))

    def owner_table(self, schedule: SteadySchedule) -> list[list[bool]]:
        """(chip, slot) -> does this chip serve this round slot?

        The packed analogue of ``SteadySchedule.owner_table``: chip
        ``offsets[i] + (w % r_i)`` owns slot w of stage i's round.
        """
        self._check(schedule)
        w = schedule.round_width
        table = [[False] * w for _ in range(self.n_chips)]
        for i in range(self.n_stages):
            for slot in range(w):
                table[self.chip_of(i, schedule.replica_of(i, slot))][slot] = True
        return table

    def slot_perm(self, schedule: SteadySchedule,
                  slot: int) -> list[tuple[int, int]]:
        """Inter-stage routing for one round slot over the flat chip
        axis: the chip serving the slot at stage i ships its boundary
        payload straight to the chip serving it at stage i+1."""
        self._check(schedule)
        return [(self.chip_of(i, schedule.replica_of(i, slot)),
                 self.chip_of(i + 1, schedule.replica_of(i + 1, slot)))
                for i in range(self.n_stages - 1)]

    def _check(self, schedule: SteadySchedule) -> None:
        if tuple(schedule.replicas) != self.replicas:
            raise ValueError(
                f"schedule replicas {tuple(schedule.replicas)} do not match "
                f"assignment replicas {self.replicas}")


def pack_replicas(replicas: Sequence[int]) -> ChipAssignment:
    """Pack a replica vector onto the minimum number of chips.

    Returns the contiguous sum-of-replicas assignment — the §III-E
    accounting under which ``Fleet`` budgets and ``autoplan`` feasibility
    admit unbalanced plans a rectangular mesh would reject.
    """
    return ChipAssignment(tuple(int(r) for r in replicas))

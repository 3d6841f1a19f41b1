"""Placement-geometry invariants (OCM03x, paper §III-E).

Statically re-derives the staggered schedule's routing facts from a
replica vector and checks that what the runtime would build is sound:
slot-level ppermute pairings form bijections on the rectangular
(stage, replica) mesh *and* the packed sum-of-replicas chip axis,
ownership tables cover every slot exactly once, the output conveyor's
bank rows cover all rounds injectively, serving geometry divides, and
chip accounting matches the §III-E sum-of-replicas rule.
"""
from __future__ import annotations

import functools
import math

from repro_torch.core.stap import SteadySchedule

from .report import Finding, finding

__all__ = ["permute_findings", "serving_findings", "chip_findings",
           "conveyor_findings"]


def _round_width(replicas) -> int:
    return functools.reduce(math.lcm, replicas, 1)


# -- OCM030: permute-table bijections ---------------------------------------

def permute_findings(replicas, n_spans: int, locus: str) -> list[Finding]:
    """OCM030: every slot's inter-stage pairing must be a bijection
    (distinct sources, distinct destinations, indices on the mesh) on
    both device layouts the runtime can compile — the rectangular
    (stage, replica) mesh (``SteadySchedule.slot_perm``) and the packed
    sum-of-replicas chip axis (``ChipAssignment.slot_perm``)."""
    from ..calibrate.placement import ChipAssignment

    replicas = tuple(int(r) for r in replicas)
    out: list[Finding] = []
    if len(replicas) != n_spans:
        out.append(finding(
            "OCM030", locus,
            f"replica vector {replicas} spans {len(replicas)} stages but "
            f"the partition has {n_spans} spans; the permute table "
            f"cannot pair one stage per span",
            replicas=list(replicas), n_spans=n_spans))
        return out
    if any(r < 1 for r in replicas):
        out.append(finding(
            "OCM030", locus,
            f"replica vector {replicas} has an empty stage; its slots "
            f"have no owner and the permute pairing is not a bijection",
            replicas=list(replicas)))
        return out

    width = _round_width(replicas)
    sched = SteadySchedule(replicas, width)
    n_stages, r = sched.n_stages, sched.max_replicas

    for slot in range(width):
        pairs = sched.slot_perm(slot)
        srcs, dsts = [p[0] for p in pairs], [p[1] for p in pairs]
        bad = (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
               or any(not 0 <= i < n_stages * r for i in srcs + dsts))
        if bad:
            out.append(finding(
                "OCM030", locus,
                f"slot {slot} ppermute pairing {pairs} is not a "
                f"bijection on the {n_stages}x{r} (stage, replica) mesh",
                slot=slot, pairs=[list(p) for p in pairs]))

    owners = sched.owner_table()
    for i in range(n_stages):
        for slot in range(width):
            n_owners = sum(owners[i][j][slot] for j in range(r))
            if n_owners != 1:
                out.append(finding(
                    "OCM030", locus,
                    f"stage {i} slot {slot} has {n_owners} owning "
                    f"replicas (want exactly 1)",
                    stage=i, slot=slot, owners=n_owners))

    asn = ChipAssignment(replicas)
    packed = asn.owner_table(sched)
    for slot in range(width):
        per_slot = sum(packed[c][slot] for c in range(asn.n_chips))
        if per_slot != n_stages:
            out.append(finding(
                "OCM030", locus,
                f"packed mesh: slot {slot} is served by {per_slot} "
                f"chips across {n_stages} stages (want one per stage)",
                slot=slot, chips=per_slot))
        pairs = asn.slot_perm(sched, slot)
        srcs, dsts = [p[0] for p in pairs], [p[1] for p in pairs]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or any(not 0 <= c < asn.n_chips for c in srcs + dsts)):
            out.append(finding(
                "OCM030", locus,
                f"packed mesh: slot {slot} pairing {pairs} is not a "
                f"bijection on the {asn.n_chips}-chip axis",
                slot=slot, pairs=[list(p) for p in pairs]))
    return out


# -- OCM031: serving-geometry divisibility ----------------------------------

def serving_findings(plan, locus: str,
                     replicas=None) -> list[Finding]:
    """OCM031: the plan's recorded serving defaults must divide. The
    ring holds one round per pipeline stage (``ring_depth == n_spans``);
    a recorded ``round_batch`` must be a positive multiple of the round
    width once a replica vector fixes it (satellite of the
    ``Deployment.serve`` time validation)."""
    out: list[Finding] = []
    rd = plan.serving.ring_depth
    if rd is not None and rd != plan.n_spans:
        out.append(finding(
            "OCM031", locus,
            f"recorded serving.ring_depth {rd} != {plan.n_spans} "
            f"pipeline stages (the ring holds one round per stage)",
            ring_depth=rd, n_spans=plan.n_spans))
    rb = plan.serving.round_batch
    if rb is not None:
        if rb < 1:
            out.append(finding(
                "OCM031", locus,
                f"recorded serving.round_batch {rb} is not positive",
                round_batch=rb))
        elif replicas is not None:
            width = _round_width(tuple(int(r) for r in replicas))
            if rb % width != 0:
                out.append(finding(
                    "OCM031", locus,
                    f"recorded serving.round_batch {rb} is not a "
                    f"multiple of the round width {width} "
                    f"(lcm of replicas {tuple(replicas)})",
                    round_batch=rb, round_width=width,
                    replicas=list(replicas)))
    return out


# -- OCM032: chip accounting ------------------------------------------------

def chip_findings(kind: str, replicas, chips: int, locus: str,
                  fleet=None) -> list[Finding]:
    """OCM032: a pipeline candidate occupies exactly ``sum(replicas)``
    chips (§III-E sum-of-replicas accounting), a single-chip candidate
    exactly 1, and either must fit the fleet's budget."""
    from ..place import SINGLE

    replicas = tuple(int(r) for r in replicas)
    out: list[Finding] = []
    expected = 1 if kind == SINGLE else sum(replicas)
    if chips != expected:
        out.append(finding(
            "OCM032", locus,
            f"{kind} candidate scores chips={chips} but replicas "
            f"{replicas} occupy {expected} (sum-of-replicas accounting)",
            kind=kind, chips=chips, replicas=list(replicas),
            expected=expected))
    if fleet is not None and expected > fleet.chips:
        out.append(finding(
            "OCM032", locus,
            f"candidate needs {expected} chips but the fleet has only "
            f"{fleet.chips}",
            needed=expected, fleet_chips=fleet.chips))
    return out


# -- OCM033: output conveyor coverage ---------------------------------------

def conveyor_findings(n_stages: int, locus: str,
                      max_rounds: int | None = None) -> list[Finding]:
    """OCM033: the output conveyor's bank-row assignment
    (``output_bank_row``) must place every round injectively into the
    ``n_stages x ceil(rounds/n_stages)`` bank — otherwise a stage would
    overwrite an undrained round. Checked over every round count up to
    two full ring cycles (the assignment is periodic in ``n_stages``)."""
    from repro_torch.runtime.stap_pipeline import output_bank_row

    out: list[Finding] = []
    if n_stages < 1:
        return out
    top = max_rounds or (2 * n_stages + 1)
    for n_rounds in range(1, top + 1):
        chunk = -(-n_rounds // n_stages)  # ceil
        seen: dict[tuple[int, int], int] = {}
        for rg in range(n_rounds):
            row = output_bank_row(rg, n_rounds, n_stages)
            slot = rg // n_stages
            if not 0 <= row < n_stages or slot >= chunk:
                out.append(finding(
                    "OCM033", locus,
                    f"round {rg} of {n_rounds} lands outside the "
                    f"{n_stages}x{chunk} output bank (row {row}, "
                    f"slot {slot})",
                    round=rg, n_rounds=n_rounds, row=row, slot=slot))
                continue
            if (row, slot) in seen:
                out.append(finding(
                    "OCM033", locus,
                    f"rounds {seen[(row, slot)]} and {rg} of {n_rounds} "
                    f"collide in output bank cell (row {row}, slot "
                    f"{slot}); the later round would overwrite the "
                    f"earlier before drain",
                    rounds=[seen[(row, slot)], rg], n_rounds=n_rounds,
                    row=row, slot=slot))
            seen[(row, slot)] = rg
    return out

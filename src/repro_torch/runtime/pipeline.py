"""Occam pipeline runtime: DP-optimal partitions as pipeline stages, the
port of ``repro/runtime/pipeline.py``.

This is contribution C3+C4 made executable for transformers:

  1. ``plan_stages`` — run the paper's DP (repro_torch.core.partition) over
     the layer chain with an HBM capacity model -> contiguous layer spans,
     then STAP replication counts for the bottleneck stages from a stage
     latency model (FLOPs / chip rate; see repro_torch.core.stap).
  2. ``pipeline_forward`` — an executable GPipe-style microbatch pipeline
     over the positions of a ``DeviceMesh`` axis: each stage holds only
     its span's weights, resident on its position's device, microbatches
     stream through, and boundary activations are the only inter-stage
     traffic (exactly the quantity the DP minimized).

The schedule runs S + M - 1 ticks for S stages x M microbatches. STAP
*staggering* (microbatch m -> replica m mod r_i) runs too: pass a ``plan``
(or per-stage replica counts) and a (stage, replica) mesh, and
``pipeline_forward`` delegates to the round executor of
``repro_torch.runtime.stap_pipeline.replicated_forward``.

The reference runs the schedule inside ``shard_map`` with a ``ppermute``
per tick; here one controller loops over ticks and stage positions, as
the port's STAP executor does, and a hop is a copy to the receiving
position's device (``stap_pipeline._hop``). A device may fill several
positions: every stage on one GPU runs the same schedule on one stream.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.partition import PartitionResult, partition_transformer
from repro_torch.core.stap import StapPlan, plan_replication
from repro_torch.runtime import stap_pipeline
from repro_torch.runtime.stap_pipeline import DeviceMesh


@dataclasses.dataclass(frozen=True)
class StagePlan:
    partition: PartitionResult
    stage_spans: tuple[tuple[int, int], ...]
    stage_flops: tuple[float, ...]
    stap: StapPlan


def plan_stages(layer_weight_bytes: Sequence[float],
                layer_act_bytes: Sequence[float],
                layer_flops: Sequence[float],
                boundary_act_bytes: float,
                stage_capacity_bytes: float,
                chip_flops_per_s: float = 197e12,
                extra_chips: int = 0) -> StagePlan:
    """DP partition -> stages; STAP replication under a chip budget."""
    part = partition_transformer(layer_weight_bytes, layer_act_bytes,
                                 boundary_act_bytes, stage_capacity_bytes)
    spans = tuple((sp.start, sp.end) for sp in part.spans)
    flops = tuple(float(sum(layer_flops[a:b])) for a, b in spans)
    times = [f / chip_flops_per_s for f in flops]
    stap = plan_replication(times, max_chips=len(spans) + extra_chips)
    return StagePlan(part, spans, flops, stap)


def pipeline_forward(stage_fn: Callable, stage_params,
                     microbatches: torch.Tensor, mesh: DeviceMesh,
                     axis: str = "stage",
                     plan: StapPlan | Sequence[int] | None = None
                     ) -> torch.Tensor:
    """Run M microbatches through S pipeline stages.

    stage_fn(stage_params_slice, x) -> y, same shape as x.
    stage_params: the reference's form, a tensor or dict of tensors with a
        leading stage dim S on every leaf (stage s holds slice s: its
        Occam span's weights, resident for the whole stream), or a
        length-S sequence of per-stage objects (e.g. ``nn.ModuleList``
        slices of a decoder's layers).
    microbatches: (M, mb, ...).
    mesh: S positions along ``axis`` (the port's ``DeviceMesh``; a device
        may repeat).
    plan: optional STAP replication — a :class:`StapPlan` or per-stage
        replica counts. Requires ``mesh`` to carry a second ("replica")
        axis of width max(replicas); microbatch m is staggered onto
        replica m mod r_i (paper §III-E) by
        ``stap_pipeline.replicated_forward``.
    Returns (M, mb, ...) outputs on the last stage's device (with a
    ``plan``, on the first position's).

    At tick t stage i serves microbatch t - i. The reference runs every
    stage at every tick and zeroes the results of inactive (stage, tick)
    pairs; the port skips them, which gives the same outputs and calls
    ``stage_fn`` S x M times, not S x (S + M - 1).
    """
    if plan is not None:
        if not isinstance(plan, StapPlan):
            # synthesize a plan from bare replica counts; with unit stage
            # times the closed-form throughput min_i r_i/t_i is min(reps)
            reps = tuple(int(r) for r in plan)
            plan = StapPlan((1.0,) * len(reps), reps, float(min(reps)),
                            float(len(reps)), sum(reps))
        replica_axis = next(
            (a for a in mesh.axis_names if a != axis),
            stap_pipeline.REPLICA_AXIS)
        return stap_pipeline.replicated_forward(
            stage_fn, stage_params, microbatches, mesh, plan,
            stage_axis=axis, replica_axis=replica_axis)

    devs = mesh.along(axis)
    s_stages, m = len(devs), microbatches.shape[0]
    params = stap_pipeline.position_stage_params(
        stap_pipeline.stage_slices(stage_params, s_stages), devs,
        range(s_stages))
    # boundary activations move one hop down the chain (the only
    # inter-stage traffic — the DP's minimized quantity)
    perm = [[(i, i + 1) for i in range(s_stages - 1)]]
    slot_shape = (1,) + tuple(microbatches.shape[1:])
    buf = [None] * s_stages
    outs = []
    for t in range(s_stages + m - 1):
        ys = []
        for i in range(s_stages):
            mb_id = t - i
            y = None
            if 0 <= mb_id < m:
                x_in = microbatches[mb_id].to(devs[0]) if i == 0 \
                    else buf[i][0]
                y = stage_fn(params[i], x_in)
            ys.append([y])
        # the last stage banks its finished microbatch
        if ys[-1][0] is not None:
            outs.append(ys[-1][0])
        if s_stages > 1:
            buf = stap_pipeline._hop(ys, perm, devs, slot_shape,
                                     microbatches.dtype)
    return torch.stack(outs)

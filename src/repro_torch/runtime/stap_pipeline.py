"""Executable STAP runtime: staggered, replicated multi-device span pipeline.

The paper's §III-E made runnable: a ``PartitionResult`` (the DP's optimal
spans) executes as a pipeline over a ``(stage, replica)`` grid of mesh
positions, each position a ``torch.device``.

* Each stage holds *only its span's weights*, resident on its positions'
  devices for the whole stream.
* Mini-batch ``m`` is staggered onto replica ``m % r_i`` of stage ``i``
  following the :class:`~repro_torch.core.stap.StapPlan`; the lock-step
  tick schedule (ownership, fill/drain, routing) comes from
  :func:`~repro_torch.core.stap.staggered_schedule`.
* Boundary activations (the span-boundary map plus every residual source
  crossing the cut, exactly the per-boundary quantity the DP minimized)
  move between stages slot by slot: the replica that served a slot copies
  it straight into the receive buffer of the replica that serves it next,
  on that replica's device. A position that no replica sends to receives
  zeros, as under JAX's ``ppermute``.
* Stage bodies dispatch through the engine registry
  (``EngineSpec.make_spmd_body``): kernel-routed spans launch the CUDA
  fused-span kernel on a CUDA position (its plain version on a CPU
  position), scan-routed spans the row-streaming loop, and oversized single
  layers the oracle, per ``repro_torch.runtime.span_engine.plan_routes``.

One controller drives the whole grid, as ``shard_map`` does in the
reference: the host loops over ticks, and within a tick over positions and
slots. The owner and live tables are host data, so a skipped slot costs
nothing and no device value is read back per tick. A device may repeat in
the grid: one GPU (``device="cuda:0"`` at compile time) or the CPU hosts
every position, and several GPUs exchange payloads by peer copies. A grid
that mixes CPU and CUDA positions is refused.

Input staging keeps the reference's conveyor: stage row i holds rounds
[i*chunk, (i+1)*chunk) of the stream, and each tick every row forwards
its queue head one hop toward stage 0. Output staging is the same in
reverse: the last stage injects each finished round into a cyclic
output conveyor that banks it on ``output_bank_row``'s row, so each row
banks ceil(rounds/S) rounds (``collect_staged_outputs`` undoes the
banking).

Two executable forms share the span stages:

* :class:`StapPipeline` — the fixed-round batch program over the whole
  staggered schedule, built per stream length.
* :class:`StapRing` — the serving form: ONE fixed-shape tick (a ring of
  rounds, one per stage) iterated by the caller, so a single build serves
  an unbounded stream of mixed submit sizes
  (``repro_torch.occam.Deployment.serve`` builds sessions on it).

:func:`replicated_forward` runs the same round executor over same-shape
stages of any ``stage_fn`` (an LM's layer spans): the ``plan=`` path of
``repro_torch.runtime.pipeline.pipeline_forward``.

The static planning half (:class:`PayloadSpec`, :func:`payload_spec`,
:class:`StageSpec`, :func:`plan_span_stages`, :func:`model_stage_times`)
is the reference's text; ``occam.autoplan`` scores candidates with it and
``Deployment.profile`` measures the stages it describes.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.graph import NetSpec
from repro_torch.core.partition import PartitionResult
from repro_torch.core.stap import (StaggeredSchedule, StapPlan,
                                   plan_replication, staggered_schedule,
                                   steady_schedule)
from repro_torch.models import cnn
from repro_torch.occam import registry, trace
from repro_torch.runtime import span_engine

STAGE_AXIS = "stage"
REPLICA_AXIS = "replica"
CHIP_AXIS = "chip"
PACKINGS = ("rect", "sum")


# --------------------------------------------------------------------------
# Static planning: boundary payloads and per-span stages
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """What crosses a partition cut: the boundary map plus every residual
    source with an edge straddling the cut. ``elems`` is therefore exactly
    the per-boundary quantity the DP charges (one direction)."""

    cut: int
    keys: tuple[int, ...]   # [cut, *sorted crossing residual sources]
    elems: int              # per-image payload elements


def payload_spec(net: NetSpec, cut: int) -> PayloadSpec:
    extras = sorted({s for (s, t) in net.residual_edges if s < cut < t})
    keys = (cut, *extras)
    return PayloadSpec(cut, keys, sum(net.map_elems(k) for k in keys))


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a span, its engine route, and its payloads."""

    route: span_engine.SpanRoute
    in_spec: PayloadSpec
    out_spec: PayloadSpec
    spill: tuple[int, ...]     # interior maps this span must materialize
    src_keys: tuple[int, ...]  # upstream sources consumed from the payload

    @property
    def span(self) -> tuple[int, int]:
        return self.route.start, self.route.end


def plan_span_stages(net: NetSpec,
                     partition: PartitionResult | Sequence[int],
                     routes: Sequence[span_engine.SpanRoute] | None = None
                     ) -> tuple[StageSpec, ...]:
    """Pure function of net + partition: spans -> pipeline stages.

    ``routes`` overrides the registry's auto dispatch (forced backends
    from ``Placement.compile``); it must cover exactly the partition's
    spans."""
    boundaries = span_engine._boundaries_of(partition, net)
    if routes is None:
        routes = span_engine.plan_routes(net, partition)
    crossing = [(s, t) for (s, t) in net.residual_edges
                if any(s < p < t for p in boundaries)]
    spill_sources = {s for (s, _t) in crossing}
    stages = []
    for route in routes:
        a, b = route.start, route.end
        stages.append(StageSpec(
            route=route,
            in_spec=payload_spec(net, a),
            out_spec=payload_spec(net, b),
            spill=tuple(sorted(m for m in spill_sources if a < m < b)),
            src_keys=tuple(sorted({s for (s, t) in net.residual_edges
                                   if s < a < t <= b})),
        ))
    return tuple(stages)


def model_stage_times(net: NetSpec, stages: Sequence[StageSpec]
                      ) -> tuple[float, ...]:
    """Per-stage latency model for planning when no measured times exist:
    conv MACs plus pool window ops (arbitrary units — only ratios matter
    to ``plan_replication``)."""
    times = []
    for st in stages:
        a, b = st.span
        ops = 0
        for layer in net.layers[a:b]:
            ops += layer.macs if layer.kind == "conv" \
                else layer.out_elems * layer.k * layer.k
        times.append(float(max(ops, 1)))
    return tuple(times)


def default_stap_plan(stage_times: Sequence[float], *,
                      max_chips: int | None = None,
                      max_replicas: int | None = None,
                      target_period: float | None = None,
                      mesh: "DeviceMesh | None" = None,
                      devices: Sequence | None = None,
                      harmonize: bool = False) -> StapPlan:
    """The replication-planning defaults shared by :class:`StapPipeline`
    and ``repro_torch.occam.Plan.place``: cap replicas at what the
    available (stage, replica) grid can physically hold, and treat a
    replica-capable mesh with no stated budget as a budget of the whole
    mesh. With neither ``mesh`` nor ``devices`` the available devices are
    the visible CUDA devices."""
    n_stages = len(stage_times)
    if max_replicas is None:
        # cap replication at what the (stage, replica) grid can physically
        # hold, so natural chip budgets plan meshes that actually exist
        if mesh is not None:
            max_replicas = mesh.shape.get(REPLICA_AXIS, 1)
        else:
            n_dev = len(devices) if devices is not None \
                else torch.cuda.device_count()
            max_replicas = max(1, n_dev // n_stages)
    if mesh is not None and max_chips is None and target_period is None:
        # a replica-capable mesh with no stated budget means "use it":
        # water-fill up to the positions the mesh holds (the schedule must
        # match the mesh shape exactly)
        max_chips = n_stages * max_replicas
    return plan_replication(stage_times, target_period=target_period,
                            max_chips=max_chips, max_replicas=max_replicas,
                            harmonize=harmonize)


# --------------------------------------------------------------------------
# The device mesh: a grid of positions, each a torch.device
# --------------------------------------------------------------------------

class DeviceMesh:
    """A grid of mesh positions with named axes, the port's counterpart of
    JAX's ``Mesh``: ``devices`` is a numpy object array of
    ``torch.device``, ``shape`` maps each axis name to its length. A
    device may fill several positions. Positions must be all CUDA devices
    or all the CPU: a mixed grid raises."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        kinds = sorted({d.type for d in devices.flat})
        if len(kinds) > 1:
            raise ValueError(
                f"a mesh's positions must be all CUDA devices or all the "
                f"CPU, got {kinds}: a pipeline does not move payloads "
                f"between the host and a GPU")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list[torch.device]:
        """The positions in row-major order (the flat position index)."""
        return list(self.devices.flat)

    def along(self, axis: str) -> list[torch.device]:
        """The positions along ``axis``, every other axis at index 0."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {sorted(set(map(str, self.flat)))})"


def _mesh_devices(need: int, devices: Sequence | None,
                  what: str) -> list[torch.device]:
    """The first ``need`` of ``devices`` (default: the visible CUDA
    devices), raising when there are fewer."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        have = f"{len(devs)} given"
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        have = f"{len(devs)} visible CUDA devices"
    if len(devs) < need:
        raise ValueError(
            f"{what} needs {need} device positions, have {have}; a device "
            f"may repeat: devices=[torch.device('cuda:0')] * {need} (or "
            f"compile(device=\"cuda:0\")) hosts every position on one GPU, "
            f"device=\"cpu\" on the CPU")
    return devs[:need]


def _grid(devs: list[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def stap_mesh(n_stages: int, max_replicas: int,
              devices: Sequence | None = None) -> DeviceMesh:
    """A (stage, replica) mesh over the first n_stages*max_replicas
    devices (default: the visible CUDA devices)."""
    need = n_stages * max_replicas
    devs = _mesh_devices(need, devices,
                         f"a STAP mesh of {n_stages}x{max_replicas}")
    return DeviceMesh(_grid(devs, (n_stages, max_replicas)),
                      (STAGE_AXIS, REPLICA_AXIS))


def packed_mesh(n_chips: int, devices: Sequence | None = None) -> DeviceMesh:
    """A flat 1-D chip mesh over the first ``n_chips`` devices — the
    sum-of-replicas layout (§III-E): a 4-3-2 plan occupies 9 positions,
    not a rectangular 3x4 = 12."""
    devs = _mesh_devices(n_chips, devices, "a packed STAP mesh")
    return DeviceMesh(_grid(devs, (n_chips,)), (CHIP_AXIS,))


# --------------------------------------------------------------------------
# Payload packing (the flat, zero-padded wire format)
# --------------------------------------------------------------------------

def _pack(parts: dict[int, torch.Tensor], spec: PayloadSpec,
          width: int) -> torch.Tensor:
    """{map -> (mb, h, w, c)} -> (mb, width) zero-padded flat payload."""
    first = parts[spec.keys[0]]
    mb = first.shape[0]
    out = first.new_zeros((mb, width))
    off = 0
    for k in spec.keys:
        flat = parts[k].reshape(mb, -1)
        out[:, off:off + flat.shape[1]] = flat
        off += flat.shape[1]
    return out


def _unpack(payload: torch.Tensor, spec: PayloadSpec,
            net: NetSpec) -> dict[int, torch.Tensor]:
    """(mb, width) payload -> {map -> (mb, h, w, c)} views of it (not
    contiguous: rows are ``width`` apart)."""
    parts, off = {}, 0
    for k in spec.keys:
        h, w, c = net.map_shape(k)
        n = h * w * c
        parts[k] = payload[:, off:off + n].reshape(-1, h, w, c)
        off += n
    return parts


# --------------------------------------------------------------------------
# The generic round executor
# --------------------------------------------------------------------------

def feed_chunk_rounds(n_rounds: int, n_stages: int) -> int:
    """Rounds of input feed resident per stage row: ceil(n_rounds / S)."""
    return -(-n_rounds // n_stages)


def out_chunk_rounds(n_rounds: int, n_stages: int) -> int:
    """Rounds of output banked per stage row — the same ceil(n_rounds / S)
    chunking as the input side (one rule, two conveyors)."""
    return feed_chunk_rounds(n_rounds, n_stages)


def output_bank_row(rg, n_rounds: int, n_stages: int):
    """Bank row of finished round ``rg`` under the output conveyor.

    Round rg finishes on the last stage row at tick rg + S - 1 and then
    hops cyclically (row S-1 -> 0 -> 1 -> ...) for h = (rounds-1-rg) mod S
    hops, landing on row (S-1+h) mod S. The reverse round-robin assignment
    is forced by finishing times: the *last* round finishes on the final
    tick and must bank with zero hops (row S-1), round rounds-2 gets at
    most one hop, and so on — so the conveyor drains within the schedule's
    existing ticks, with no extra drain ticks, while still spreading the
    rounds evenly (ceil(rounds/S) per row, round rg in bank slot rg // S).
    """
    return (n_rounds + n_stages - 2 - rg) % n_stages


def collect_staged_outputs(out: torch.Tensor, sched: StaggeredSchedule
                           ) -> torch.Tensor:
    """Undo the output conveyor's banking: the staged (S * R * chunk,
    width, *slot) executor output -> (n_rounds, width, *slot) finished
    rounds in stream order, replica partials summed (each replica banked
    only its owned slots, zeros elsewhere; an integer payload widens to
    int64 in the sum)."""
    s, r, rounds = sched.n_stages, sched.max_replicas, sched.n_rounds
    chunk = out_chunk_rounds(rounds, s)
    arr = out.reshape((s, r, chunk) + tuple(out.shape[1:])).sum(dim=1)
    rg = np.arange(rounds)
    rows = torch.as_tensor(output_bank_row(rg, rounds, s), device=out.device)
    return arr[rows, torch.as_tensor(rg // s, device=out.device)]


def stage_feed(feed: torch.Tensor, n_stages: int) -> torch.Tensor:
    """Pad a (n_rounds, ...) feed to (S * chunk, ...) for stage staging.

    Stage row i initially holds rounds [i*chunk, (i+1)*chunk) — the input
    conveyor (see ``_round_executor``) walks them to stage 0 in time."""
    chunk = feed_chunk_rounds(feed.shape[0], n_stages)
    pad = n_stages * chunk - feed.shape[0]
    if not pad:
        return feed
    return torch.cat([feed, feed.new_zeros((pad,) + tuple(feed.shape[1:]))])


def _hop(ys: Sequence[Sequence], perms: Sequence, devs: Sequence,
         shape: tuple[int, ...], dtype: torch.dtype) -> list[torch.Tensor]:
    """One tick's boundary hop: a fresh zeroed receive buffer of ``shape``
    (slot-major) per position on its device (the send side of the double
    buffer, never the buffer read this tick), then for each slot ``w`` one
    copy per (sender, receiver) pair of ``perms[w]`` whose sender ran that
    slot (``ys[src][w]`` is not None). A position that no pair sends to
    receives zeros, as under ``ppermute``."""
    out = [torch.zeros(shape, dtype=dtype, device=d) for d in devs]
    for w, perm in enumerate(perms):
        for src, dst in perm:
            if ys[src][w] is not None:
                out[dst][w].copy_(ys[src][w])
    return out


def _check_mesh(mesh: DeviceMesh, sched: StaggeredSchedule,
                stage_axis: str, replica_axis: str) -> None:
    """Slot routing is computed over a (n_stages, max_replicas) grid; a
    mismatched mesh would silently misroute every payload to zeros."""
    s_stages, r_max = sched.n_stages, sched.max_replicas
    got = (mesh.shape.get(stage_axis), mesh.shape.get(replica_axis))
    if got != (s_stages, r_max):
        raise ValueError(
            f"mesh is {stage_axis}={got[0]}, {replica_axis}={got[1]} but "
            f"the schedule needs {s_stages}x{r_max} (replicas "
            f"{sched.replicas}); build it with stap_mesh({s_stages}, "
            f"{r_max})")


def _round_executor(step, position_params: Sequence, feed: torch.Tensor,
                    mesh: DeviceMesh, sched: StaggeredSchedule,
                    stage_axis: str = STAGE_AXIS,
                    replica_axis: str = REPLICA_AXIS) -> torch.Tensor:
    """Run the staggered lock-step schedule over the mesh's positions.

    step(stage_idx, params_here, slot) -> slot', both of ``feed``'s
    trailing slot shape. ``feed``: (n_rounds, round_width, *slot) input,
    or its ``stage_feed`` padded form (S*chunk, round_width, *slot).
    ``position_params``: one entry per mesh position in row-major order,
    already on that position's device. Returns the *staged* outputs —
    (S * R * chunk, round_width, *slot) on the first position's device,
    each stage row banking ceil(n_rounds/S) finished rounds — which
    ``collect_staged_outputs`` reassembles into (n_rounds, round_width,
    *slot).

    Tick t: stage i serves round t - i; each replica runs only its owned
    *live* slots (the tables are host data: a skipped slot costs
    nothing), then every slot's boundary payload moves one hop down the
    pipe, straight to the replica that will serve it next.

    Input staging: position (i, j) holds stage row i's chunk of rounds
    (replicated over the replica axis). Each tick every row forwards the
    round at its queue head one hop toward stage 0 and banks the round
    arriving from the row behind it in the freed slot, so row i's slot
    (t mod chunk) holds round i*chunk + t at tick t and stage 0's head is
    exactly round t when it needs it.

    Output staging is the input conveyor in reverse: the last stage row
    injects each finished round into a one-slot transit buffer that hops
    along the *cyclic* stage ring (S-1 -> 0 -> 1 -> ...) once per tick;
    the row ``output_bank_row`` assigns to the round banks it when it
    arrives, within the schedule's existing ticks.
    """
    _check_mesh(mesh, sched, stage_axis, replica_axis)
    s_stages, r_max = sched.n_stages, sched.max_replicas
    width, rounds = sched.round_width, sched.n_rounds
    chunk = feed_chunk_rounds(rounds, s_stages)
    if feed.shape[0] == rounds:
        feed = stage_feed(feed, s_stages)
    if feed.shape[0] != s_stages * chunk:
        raise ValueError(f"feed has {feed.shape[0]} rounds; schedule needs "
                         f"{rounds} (staged: {s_stages * chunk})")
    out_chunk = out_chunk_rounds(rounds, s_stages)
    owner = sched.owner_table()                                  # (S, R, W)
    live = sched.slot_live()                                     # (G*W,)
    perms = [sched.slot_perm(w) for w in range(width)]
    devs = mesh.flat
    positions = [divmod(p, r_max) for p in range(len(devs))]   # (i, j)
    slot_shape = tuple(feed.shape[2:])

    def zeros(p, lead):
        return torch.zeros(lead + slot_shape, dtype=feed.dtype,
                           device=devs[p])

    # each position's own copy of its row's chunk: the conveyor writes it
    queue = [feed[i * chunk:(i + 1) * chunk].to(devs[p], copy=True)
             for p, (i, _j) in enumerate(positions)]
    buf = [zeros(p, (width,)) for p in range(len(devs))]
    outq = [zeros(p, (out_chunk, width)) for p in range(len(devs))]
    transit = [zeros(p, (width,)) for p in range(len(devs))]
    for t in range(sched.n_ticks):
        head = t % chunk
        ys = []
        for p, (i, j) in enumerate(positions):
            rg = t - i
            yp = [None] * width          # None: a slot this tick skipped
            if 0 <= rg < rounds:
                slot_in = queue[p][head] if i == 0 else buf[p]
                for w in range(width):
                    if owner[i][j][w] and live[rg * width + w]:
                        yp[w] = step(i, position_params[p], slot_in[w])
            ys.append(yp)
        if s_stages > 1:
            # boundary payloads: one slot-level hop down the pipe
            buf = _hop(ys, perms, devs, (width,) + slot_shape, feed.dtype)
        # output conveyor: the last stage row injects its finished round
        # (zeros where it skipped); every other row takes what arrived
        # from the row before it over the cyclic ring hop
        arrived = []
        for p, (i, j) in enumerate(positions):
            if i == s_stages - 1:
                arriving = torch.stack([
                    y if y is not None else zeros(p, ()) for y in ys[p]])
            else:
                src = ((i - 1) % s_stages) * r_max + j
                arriving = transit[src].to(devs[p])
            # the round arriving at row i this tick (injected at tick
            # rg + S - 1, it reaches row i after (i + 1) mod S hops); bank
            # it here if output_bank_row says so
            rg_o = t - (i + 1) % s_stages - (s_stages - 1)
            if 0 <= rg_o < rounds and \
                    output_bank_row(rg_o, rounds, s_stages) == i:
                outq[p][rg_o // s_stages].copy_(arriving)
            arrived.append(arriving)
        transit = arrived
        if s_stages > 1:
            # input conveyor: every row forwards its head one hop toward
            # stage 0 and banks the round from the row behind it (rows in
            # increasing order: row i reads row i+1's slot before row i+1
            # overwrites it); the last row receives zeros
            for p, (i, _j) in enumerate(positions):
                if i + 1 < s_stages:
                    queue[p][head].copy_(queue[p + r_max][head])
                else:
                    queue[p][head].zero_()
    return torch.cat([q.to(devs[0]) for q in outq])


# --------------------------------------------------------------------------
# The homogeneous replicated pipeline (``pipeline_forward``'s plan= path)
# --------------------------------------------------------------------------

def stage_slices(stage_params, n_stages: int) -> list:
    """Per-stage parameters: the reference's form (a tensor, or a dict of
    tensors, with a leading stage dimension on every leaf) sliced into
    views, or a length-``n_stages`` sequence of per-stage objects (a
    module, a ``ModuleList`` slice of a decoder's layers) taken as is."""
    def check(n):
        if n != n_stages:
            raise ValueError(f"stage_params hold {n} stages; the mesh "
                             f"has {n_stages}")

    if isinstance(stage_params, torch.Tensor):
        check(stage_params.shape[0])
        return list(stage_params.unbind(0))
    if isinstance(stage_params, dict):
        for leaf in stage_params.values():
            check(leaf.shape[0])
        return [{k: v[i] for k, v in stage_params.items()}
                for i in range(n_stages)]
    check(len(stage_params))
    return list(stage_params)


def _on_device(stage, dev: torch.device):
    """One stage's parameters on ``dev``: tensors already there are
    returned as they are (no copy); a module whose tensors all sit on
    ``dev`` (``cuda`` meaning the current CUDA device) is shared, else
    copied whole."""
    if isinstance(stage, torch.Tensor):
        return stage.to(dev)
    if isinstance(stage, dict):
        return {k: _on_device(v, dev) for k, v in stage.items()}
    if isinstance(stage, torch.nn.Module):
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if all(t.device == dev for t in stage.state_dict().values()):
            return stage
        return copy.deepcopy(stage).to(dev)
    raise TypeError(f"stage parameters of type {type(stage).__name__}: "
                    f"a tensor, a dict of tensors or a module")


def position_stage_params(stages: Sequence, devs: Sequence[torch.device],
                          rows: Sequence[int]) -> list:
    """Each position's stage parameters (``rows[p]`` is position p's
    stage) on its device; positions of one stage on one device share one
    object, so replicas there share the stage's tensors."""
    placed: dict[tuple, object] = {}
    out = []
    for i, dev in zip(rows, devs):
        if (i, dev) not in placed:
            placed[(i, dev)] = _on_device(stages[i], dev)
        out.append(placed[(i, dev)])
    return out


def replicated_forward(stage_fn, stage_params, microbatches: torch.Tensor,
                       mesh: DeviceMesh, plan: StapPlan,
                       stage_axis: str = STAGE_AXIS,
                       replica_axis: str = REPLICA_AXIS) -> torch.Tensor:
    """Homogeneous replicated pipeline (the ``pipeline_forward``
    generalization): same-shape stages, microbatch m -> replica m % r_i.

    stage_fn(params_slice, x) -> y with y.shape == x.shape; stage_params
    in either form ``stage_slices`` takes; microbatches is (M, mb, ...).
    Returns the (M, mb, ...) last-stage outputs on the first position's
    device. Only live slots run (``_round_executor``): stage_fn is called
    S x M times.
    """
    m = microbatches.shape[0]
    sched = staggered_schedule(plan, m)
    _check_mesh(mesh, sched, stage_axis, replica_axis)
    pad = sched.n_slots - m
    feed = microbatches
    if pad:
        feed = torch.cat([feed, feed.new_zeros((pad,) + feed.shape[1:])])
    feed = feed.reshape((sched.n_rounds, sched.round_width)
                        + tuple(microbatches.shape[1:]))
    r_max = sched.max_replicas
    devs = mesh.flat
    params = position_stage_params(
        stage_slices(stage_params, sched.n_stages), devs,
        [p // r_max for p in range(len(devs))])

    def step(_i, params_here, slot):
        return stage_fn(params_here, slot)

    staged = _round_executor(step, params, feed, mesh, sched,
                             stage_axis=stage_axis,
                             replica_axis=replica_axis)
    outs = collect_staged_outputs(staged, sched)
    return outs.reshape((sched.n_slots,) + tuple(microbatches.shape[1:]))[:m]


# --------------------------------------------------------------------------
# The span pipeline: heterogeneous Occam spans as per-stage bodies
# --------------------------------------------------------------------------

def _payload_casts(policy):
    """(dequant, quant) boundary transforms for a policy: identity for
    None / the implicit fp32 policy; otherwise dequant lifts a payload
    into the policy's compute dtype at span entry and quant drops a span
    output back to the boundary dtype before it is packed for transport.
    """
    if policy is None or policy.is_default:
        ident = lambda arr: arr  # noqa: E731
        return ident, ident
    from repro_torch.occam.quant import casting

    def dequant(q):
        return casting.dequantize(q, policy.boundary, policy.scale,
                                  compute=policy.compute)

    def quant(x):
        return casting.quantize(x, policy.boundary, policy.scale)

    return dequant, quant


def make_stage_body(net: NetSpec, stage: StageSpec, payload_width: int,
                    out_rows: int = 1, policy=None):
    """One stage's body ``body(span_params, slot) -> slot'``: unpack the
    boundary payload, run the span core the registry resolved for the
    route, and pack the outgoing payload (output map + spills + forwarded
    upstream sources). ``span_params`` is the span's list of per-layer
    ``{"w", "b"}`` dicts (``{}`` for a pool) on the slot's device.

    ``policy`` (an ``occam.quant.DtypePolicy``) makes the boundary
    genuinely quantized: the slot arrives in the boundary dtype,
    dequantizes at span entry (the span core computes in
    ``policy.compute``), and the outgoing map / spills quantize back
    before packing. Forwarded upstream sources stay in their transport
    form — a map that rides several hops is quantized exactly once."""
    a, b = stage.span
    spec = registry.resolve_spmd_engine(stage.route.route)
    # per-stage effective tile height: a deep net's tail spans have
    # short output maps, so the planned out_rows clamps per span
    t = max(1, min(out_rows, net.map_shape(b)[0]))
    core = spec.make_spmd_body(net, a, b, stage.spill, stage.src_keys,
                               out_rows=t)
    dequant, quant = _payload_casts(policy)

    def body(span_params, slot):
        parts = _unpack(slot, stage.in_spec, net)
        x = dequant(parts[a])
        srcs = tuple(dequant(parts[s]) for s in stage.src_keys)
        out, spilled = core(span_params, x, srcs)
        out_parts = {}
        for s in stage.out_spec.keys:
            if s == b:
                out_parts[s] = quant(out)
            elif s in spilled:
                out_parts[s] = quant(spilled[s])
            else:
                # an upstream source (or this span's input): forward the
                # transport form, not a dequantized compute copy
                out_parts[s] = parts[s]
        return _pack(out_parts, stage.out_spec, payload_width)

    return body


class _SpanProgram:
    """Shared static planning for the STAP executors: spans -> stages
    whose bodies dispatch through the engine registry
    (``EngineSpec.make_spmd_body``), the flat payload width, each
    position's span parameters, and the device mesh.
    :class:`StapPipeline` (fixed-round batch program) and
    :class:`StapRing` (single-tick serving step) both build on it."""

    def __init__(self, net: NetSpec,
                 partition: PartitionResult | Sequence[int],
                 microbatch: int = 1, *,
                 plan: StapPlan | None = None,
                 stage_times: Sequence[float] | None = None,
                 max_chips: int | None = None,
                 max_replicas: int | None = None,
                 target_period: float | None = None,
                 mesh: DeviceMesh | None = None,
                 devices: Sequence | None = None,
                 routes: Sequence[span_engine.SpanRoute] | None = None,
                 out_rows: int = 1,
                 packing: str = "rect",
                 policy=None):
        if packing not in PACKINGS:
            raise ValueError(f"packing must be one of {PACKINGS}, "
                             f"got {packing!r}")
        # normalize the implicit fp32 policy to None so every downstream
        # hook has one no-quantization spelling
        if policy is not None and policy.is_default:
            policy = None
        self.policy = policy
        self.net = net
        self.boundaries = span_engine._boundaries_of(partition, net)
        self.stages = plan_span_stages(net, partition, routes=routes)
        n_stages = len(self.stages)
        self.microbatch = microbatch
        self.out_rows = out_rows
        self.packing = packing
        self.stage_times = tuple(stage_times) if stage_times is not None \
            else model_stage_times(net, self.stages)
        if plan is None:
            if packing == "sum":
                # sum packing exists to realize an *already chosen*
                # unbalanced replica vector on sum(replicas) positions;
                # the default planners reason in rectangular budgets
                raise ValueError("packing='sum' requires an explicit plan")
            plan = default_stap_plan(self.stage_times,
                                     target_period=target_period,
                                     max_chips=max_chips,
                                     max_replicas=max_replicas,
                                     mesh=mesh, devices=devices)
        if len(plan.replicas) != n_stages:
            raise ValueError(f"plan has {len(plan.replicas)} stages, "
                             f"partition has {n_stages}")
        self.plan = plan
        if packing == "sum":
            from repro_torch.occam.calibrate.placement import pack_replicas
            self.assignment = pack_replicas(plan.replicas)
            if mesh is None:
                mesh = packed_mesh(self.assignment.n_chips, devices)
            elif mesh.shape.get(CHIP_AXIS) != self.assignment.n_chips:
                raise ValueError(
                    f"packed mesh is {CHIP_AXIS}="
                    f"{mesh.shape.get(CHIP_AXIS)} but the plan needs "
                    f"sum(replicas) = {self.assignment.n_chips} chips; "
                    f"build it with packed_mesh({self.assignment.n_chips})")
            self.mesh = mesh
        else:
            self.assignment = None
            self.mesh = mesh if mesh is not None else stap_mesh(
                n_stages, max(plan.replicas), devices)
        self.payload_width = max(max(st.in_spec.elems, st.out_spec.elems)
                                 for st in self.stages)
        # the dtype every payload buffer (feed, ring state, hops) is
        # allocated and moved in — int8 boundaries really move a quarter
        # of the fp32 bytes
        if self.policy is None:
            self._payload_dtype = torch.float32
            self.payload_bytes_per_elem = 4.0
        else:
            from repro_torch.occam.quant import casting
            self._payload_dtype = casting.torch_dtype(self.policy.boundary)
            self.payload_bytes_per_elem = self.policy.boundary_bytes

    # -- static reporting ---------------------------------------------------

    @property
    def link_elems_per_image(self) -> int:
        """Boundary-payload elements moved per image: every interior
        boundary payload crosses its cut exactly once (per hop). This is
        the DP's minimized quantity."""
        return sum(st.out_spec.elems for st in self.stages[:-1])

    def executed_engine(self, stage: StageSpec) -> str:
        """The engine whose stage body the stage actually runs, resolved
        through the registry: the route itself when it registered a
        ``make_spmd_body`` (kernel/scan/oracle all do), else its declared
        ``spmd_fallback``."""
        return registry.resolve_spmd_engine(stage.route.route).name

    # -- execution ----------------------------------------------------------

    def _step(self):
        """step(stage_idx, span_params, slot) -> slot': the stage's body,
        picked on the host (only that stage's span runs)."""
        bodies = [make_stage_body(self.net, st, self.payload_width,
                                  out_rows=self.out_rows,
                                  policy=self.policy)
                  for st in self.stages]

        def step(i_stage, span_params, slot):
            return bodies[i_stage](span_params, slot)

        return step

    def _position_stages(self) -> tuple[int, ...]:
        """The stage of each mesh position, in flat order: row i of the
        rectangular (stage, replica) mesh, or the packed chip's assigned
        stage."""
        if self.packing == "sum":
            return self.assignment.stage_ids()
        r = self.mesh.shape[REPLICA_AXIS]
        return tuple(i for i in range(len(self.stages)) for _ in range(r))

    def _stack_params(self, params: Sequence[dict]) -> list[list[dict]]:
        """Each position's span params on its device (under a policy, in
        the weight dtype's values). Serving calls reuse the same weights,
        so the work is keyed on the given leaves themselves (held by
        reference: an id() key would go stale when a freed array's
        address is reused); positions of one stage on one device share
        one copy."""
        leaves = tuple(p[k] for p in params for k in sorted(p))
        cached = getattr(self, "_pstack_cache", None)
        if cached is not None and len(cached[0]) == len(leaves) and \
                all(a is b for a, b in zip(cached[0], leaves)):
            return cached[1]
        copies: dict[tuple, list[dict]] = {}
        out = []
        for i, dev in zip(self._position_stages(), self.mesh.flat):
            if (i, dev) not in copies:
                a, b = self.stages[i].span
                span = convert.params_from_numpy(params[a:b], dev)
                if self.policy is not None:
                    from repro_torch.occam.quant import casting
                    span = casting.quantize_params(span, self.policy)
                copies[(i, dev)] = span
            out.append(copies[(i, dev)])
        self._pstack_cache = (leaves, out)
        return out


class StapPipeline(_SpanProgram):
    """A STAP executor for one (net, partition, plan, batch) tuple.

    Build once, then ``run(params, xs)`` streams batches through the
    replicated span pipeline (repeated runs at one batch size reuse the
    stage bodies and the position params). For mixed batch sizes from one
    build, serve through :class:`StapRing` (``Deployment.serve``) instead.
    """

    def __init__(self, net: NetSpec,
                 partition: PartitionResult | Sequence[int],
                 batch: int, microbatch: int = 1, *,
                 plan: StapPlan | None = None,
                 stage_times: Sequence[float] | None = None,
                 max_chips: int | None = None,
                 max_replicas: int | None = None,
                 target_period: float | None = None,
                 mesh: DeviceMesh | None = None,
                 devices: Sequence | None = None,
                 routes: Sequence[span_engine.SpanRoute] | None = None,
                 out_rows: int = 1, policy=None):
        super().__init__(net, partition, microbatch, plan=plan,
                         stage_times=stage_times, max_chips=max_chips,
                         max_replicas=max_replicas,
                         target_period=target_period, mesh=mesh,
                         devices=devices, routes=routes, out_rows=out_rows,
                         policy=policy)
        self.batch = batch
        self.n_microbatches = -(-batch // microbatch)
        self.schedule = staggered_schedule(self.plan, self.n_microbatches)
        self._fn = self._step()

    # -- static reporting ---------------------------------------------------

    @property
    def conveyor_elems_per_image(self) -> float:
        """Input-conveyor elements moved over stage links per image: each
        of the S-1 non-final rows forwards one (round_width, mb,
        payload_width) feed slot per tick, in every replica column
        (padding included: the hop moves the whole slot)."""
        sched = self.schedule
        moved = (sched.n_ticks * (sched.n_stages - 1) * sched.max_replicas
                 * sched.round_width * self.microbatch * self.payload_width)
        return moved / self.batch

    @property
    def out_conveyor_elems_per_image(self) -> float:
        """Output-conveyor elements moved over stage links per image: the
        cyclic ring hop forwards every row's one-slot transit buffer each
        tick, in every replica column — the price of banking outputs at
        O(stream/S) per row."""
        sched = self.schedule
        if sched.n_stages == 1:
            return 0.0
        moved = (sched.n_ticks * sched.n_stages * sched.max_replicas
                 * sched.round_width * self.microbatch * self.payload_width)
        return moved / self.batch

    def report(self) -> dict:
        """Machine-readable run configuration (the reference's keys)."""
        return {
            "boundaries": list(self.boundaries),
            "spans": [list(st.span) for st in self.stages],
            "planned_routes": [st.route.route for st in self.stages],
            "engines": [self.executed_engine(st) for st in self.stages],
            "replicas": list(self.plan.replicas),
            "chips": self.plan.chips,
            "mesh_shape": [self.schedule.n_stages,
                           self.schedule.max_replicas],
            "round_width": self.schedule.round_width,
            "n_rounds": self.schedule.n_rounds,
            "n_ticks": self.schedule.n_ticks,
            "microbatch": self.microbatch,
            "n_microbatches": self.n_microbatches,
            "payload_elems": [st.out_spec.elems for st in self.stages[:-1]],
            "payload_width_padded": self.payload_width,
            "link_elems_per_image": self.link_elems_per_image,
            "conveyor_elems_per_image": self.conveyor_elems_per_image,
            "out_conveyor_elems_per_image": self.out_conveyor_elems_per_image,
            "dp_transfer_elems_per_image": cnn.predicted_transfers(
                self.net, list(self.boundaries)),
            # byte-denominated twins: payloads move in the policy's
            # boundary dtype (4.0 B/elem for the implicit fp32 policy)
            "payload_bytes_per_elem": self.payload_bytes_per_elem,
            "link_bytes_per_image":
                self.link_elems_per_image * self.payload_bytes_per_elem,
            "conveyor_bytes_per_image":
                self.conveyor_elems_per_image * self.payload_bytes_per_elem,
            "out_conveyor_bytes_per_image":
                self.out_conveyor_elems_per_image
                * self.payload_bytes_per_elem,
        }

    # -- data movement ------------------------------------------------------

    def _pack_feed(self, xs: torch.Tensor) -> torch.Tensor:
        """Flatten + pad the stream, staged for the input conveyor:
        (S * chunk, round_width, mb, payload_width), images, slots and
        rounds zero-padded, on the first position's device."""
        if self.policy is not None:
            from repro_torch.occam.quant import casting
            xs = casting.quantize(xs, self.policy.boundary,
                                  self.policy.scale)
        sched, mb = self.schedule, self.microbatch
        flat = xs.reshape(xs.shape[0], -1)
        feed = flat.new_zeros((sched.n_slots * mb, self.payload_width))
        feed[:flat.shape[0], :flat.shape[1]] = flat
        feed = feed.reshape(sched.n_rounds, sched.round_width, mb,
                            self.payload_width)
        return stage_feed(feed, sched.n_stages)

    def run(self, params: Sequence[dict], xs,
            counter: cnn.TrafficCounter | None = None) -> torch.Tensor:
        """Stream ``xs`` ((B, H, W, C), numpy or a tensor) through the
        pipeline -> (B, ...) on the first position's device. ``params``
        may be numpy or tensors anywhere.

        ``counter`` accumulates the model's off-chip transfers with the
        same engine-independent accounting as ``span_engine``
        (model == machine: totals equal ``predicted_transfers`` x batch).
        """
        xs = convert.array_from_numpy(xs, self.mesh.flat[0])
        if xs.ndim != 4:
            raise ValueError("stap pipeline streams batched (B, H, W, C)")
        if xs.shape[0] != self.batch:
            raise ValueError(f"pipeline built for batch {self.batch}, "
                             f"got {xs.shape[0]}")
        bpe = self.payload_bytes_per_elem
        for st in self.stages:
            a, b = st.span
            cnn.count_span_reads(counter, self.net, a, b, self.batch,
                                 bytes_per_elem=bpe)
            cnn.count_span_writes(counter, self.net, b, st.spill, self.batch,
                                  bytes_per_elem=bpe)
        staged = _round_executor(self._fn, self._stack_params(params),
                                 self._pack_feed(xs), self.mesh,
                                 self.schedule)
        out = collect_staged_outputs(staged, self.schedule)
        h, w, c = self.net.map_shape(self.net.n_layers)
        flat = out.reshape(self.schedule.n_slots, self.microbatch,
                           self.payload_width)[:self.n_microbatches]
        y = flat[:, :, :h * w * c].reshape(-1, h, w, c)
        if self.policy is not None:
            # the last boundary crossed in the boundary dtype; hand the
            # caller fp32 images (the replica-partial sum widened an
            # integer payload to int64; dequantize takes either)
            from repro_torch.occam.quant import casting
            y = casting.dequantize(y, self.policy.boundary,
                                   self.policy.scale)
        return y[:self.batch]


class StapRing(_SpanProgram):
    """The serving form of the STAP pipeline: ONE fixed-shape tick,
    iterated by the caller over an unbounded stream.

    Where :class:`StapPipeline` runs a whole fixed-round schedule per
    stream length, the ring builds a single round-width tick: stage i
    serves the round that entered i ticks ago, then every slot's boundary
    payload hops one stage down the pipe — the carried *ring state*, one
    pending round per position (``ring_depth`` rounds in flight). Every
    tick's shapes are fixed by (round_width, microbatch, payload_width),
    so one build serves every submit size (``trace_count``, the builds of
    the tick, stays at 1); ragged traffic is packed into fixed rounds by
    ``repro_torch.occam.Session`` with a per-stage slot-validity mask
    (masked slots skip their span body and are excluded from outputs and
    measured traffic by the session).
    """

    def __init__(self, net: NetSpec,
                 partition: PartitionResult | Sequence[int],
                 microbatch: int = 1, *,
                 plan: StapPlan,
                 mesh: DeviceMesh | None = None,
                 devices: Sequence | None = None,
                 routes: Sequence[span_engine.SpanRoute] | None = None,
                 out_rows: int = 1,
                 packing: str = "rect",
                 policy=None):
        super().__init__(net, partition, microbatch, plan=plan, mesh=mesh,
                         devices=devices, routes=routes, out_rows=out_rows,
                         packing=packing, policy=policy)
        self.steady = steady_schedule(self.plan)
        self.trace_count = 0   # tick builds; regression: stays at 1
        self._tick = None      # built by the first tick
        # windowed tick timer (occam.calibrate observability); a GPU tick
        # returns once its launches are queued, so under steady load it
        # converges to the device tick time by the queue's backpressure
        from repro_torch.occam.calibrate.timers import TickTimers
        self.timers = TickTimers()

    # -- geometry -----------------------------------------------------------

    @property
    def round_width(self) -> int:
        return self.steady.round_width

    @property
    def ring_depth(self) -> int:
        """Rounds in flight (= stages): submit-to-result latency in ticks."""
        return self.steady.ring_depth

    @property
    def round_batch(self) -> int:
        """Images per serving round: round_width slots x microbatch."""
        return self.steady.round_width * self.microbatch

    def report(self) -> dict:
        """Machine-readable serving configuration (the reference's keys;
        ``tick_lowerings`` counts the tick's builds)."""
        return {
            "boundaries": list(self.boundaries),
            "spans": [list(st.span) for st in self.stages],
            "planned_routes": [st.route.route for st in self.stages],
            "engines": [self.executed_engine(st) for st in self.stages],
            "replicas": list(self.plan.replicas),
            "chips": self.plan.chips,
            "packing": self.packing,
            "mesh_shape": ([self.assignment.n_chips]
                           if self.packing == "sum" else
                           [self.steady.n_stages, self.steady.max_replicas]),
            "round_width": self.round_width,
            "round_batch": self.round_batch,
            "ring_depth": self.ring_depth,
            "microbatch": self.microbatch,
            "payload_width_padded": self.payload_width,
            "link_elems_per_image": self.link_elems_per_image,
            "payload_bytes_per_elem": self.payload_bytes_per_elem,
            "link_bytes_per_image":
                self.link_elems_per_image * self.payload_bytes_per_elem,
            "tick_lowerings": self.trace_count,
            "tick_count": self.timers.count,
            "tick_mean_s": self.timers.mean_s(),
            "tick_busy_fraction": self.timers.busy_fraction(),
        }

    # -- the tick -----------------------------------------------------------

    def init_state(self) -> list[torch.Tensor]:
        """A zeroed ring: each position's pending-round payload slots,
        (round_width, microbatch, payload_width) in the payload dtype on
        the position's device — O(round_batch) per position,
        stream-independent."""
        return [torch.zeros((self.round_width, self.microbatch,
                             self.payload_width), dtype=self._payload_dtype,
                            device=d) for d in self.mesh.flat]

    def _build_tick(self):
        """The rectangular tick over the (stage, replica) grid."""
        steady = self.steady
        r_max = steady.max_replicas
        owner = steady.owner_table()                             # (S, R, W)
        stage_of = self._position_stages()
        return self._tick_program(
            stage_of,
            [owner[i][p % r_max] for p, i in enumerate(stage_of)],
            [steady.slot_perm(w) for w in range(steady.round_width)],
            [(steady.n_stages - 1) * r_max + j
             for j in range(steady.replicas[-1])])

    def _build_tick_packed(self):
        """The sum-of-replicas tick: the same ring semantics over a flat
        ``sum(replicas)``-position mesh. Each position knows its stage
        from the static :class:`ChipAssignment` tables; slot ownership and
        the per-slot boundary hops route over flat chip ids, so an
        unbalanced 4-3-2 plan really occupies 9 positions (§III-E) with
        no padded idle replicas."""
        steady, asg = self.steady, self.assignment
        last0 = asg.offsets[-1]
        return self._tick_program(
            asg.stage_ids(), asg.owner_table(steady),
            [asg.slot_perm(steady, w) for w in range(steady.round_width)],
            list(range(last0, last0 + asg.replicas[-1])))

    def _tick_program(self, stage_of, owner, perms, last):
        """fn(position_params, state, in_round, masks) -> (state', lanes)
        over flat positions: ``stage_of[p]``, ``owner[p][w]``, per-slot
        routing ``perms[w]`` and the last stage's positions ``last``."""
        step = self._step()
        devs = self.mesh.flat
        s_stages, width = self.steady.n_stages, self.round_width
        mb, pw = self.microbatch, self.payload_width
        h, w_out, c = self.net.map_shape(self.net.n_layers)
        out_dev = devs[last[0]]
        out_cast = self._lane_cast()

        def fn(position_params, state, in_round, masks):
            ys = []
            for p, i in enumerate(stage_of):
                slot_in = in_round.to(devs[p]) if i == 0 else state[p]
                # masks[i] is the validity of the round at stage i (the
                # session tracks what entered i ticks ago); a masked or
                # unowned slot skips its span body
                ys.append([step(i, position_params[p], slot_in[w])
                           if owner[p][w] and masks[i][w] else None
                           for w in range(width)])
            # boundary payloads hop one stage down the pipe into a fresh
            # ring state (never the state read this tick)
            new = _hop(ys, perms if s_stages > 1 else (), devs,
                       (width, mb, pw), self._payload_dtype)
            # the exiting round: last-stage positions only, replica
            # partials summed (each served only its owned slots; an
            # integer payload widens to int64), lanes cut to output images
            partials = []
            for p in last:
                zero = torch.zeros((mb, pw), dtype=self._payload_dtype,
                                   device=devs[p])
                partials.append(torch.stack(
                    [y if y is not None else zero for y in ys[p]]
                ).to(out_dev))
            out = torch.stack(partials).sum(dim=0).reshape(width * mb, pw)
            lanes = out_cast(out[:, :h * w_out * c].reshape(-1, h, w_out, c))
            return new, lanes

        return fn

    def _lane_cast(self):
        """Exit transform for the round leaving the last stage: the
        payload crossed in the boundary dtype (the replica-partial sum
        widened an integer form to int64); sessions get fp32 images."""
        if self.policy is None:
            return lambda lanes: lanes
        from repro_torch.occam.quant import casting
        pol = self.policy
        return lambda lanes: casting.dequantize(lanes, pol.boundary,
                                                pol.scale)

    def tick(self, params: Sequence[dict], state: list[torch.Tensor],
             in_round: torch.Tensor, masks
             ) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Advance the ring one tick.

        ``in_round``: (round_width, mb, payload_width) packed round
        entering stage 0 (see :meth:`pack_round`). ``masks``: (S, W) host
        bools — slot validity of the round resident at each stage this
        tick. Returns ``(state', lanes)`` where ``lanes`` (round_batch, h,
        w, c) is the round leaving the last stage (the one submitted
        ``ring_depth - 1`` ticks ago).
        """
        with trace.timed("occam.session.round", self.timers) as sp:
            if sp:
                sp.set(round=self.timers.count,
                       valid_slots=int(np.count_nonzero(masks[0])))
            if self._tick is None:
                self._tick = self._build_tick_packed() \
                    if self.packing == "sum" else self._build_tick()
                self.trace_count += 1
            return self._tick(self._stack_params(params), state, in_round,
                              np.asarray(masks, dtype=bool))

    # -- data movement ------------------------------------------------------

    def pack_round(self, xs) -> torch.Tensor:
        """(n <= round_batch, H, W, C) images -> (W, mb, payload_width)
        flat round on the first position's device, in the payload dtype,
        zero-padded on trailing lanes (mask them)."""
        xs = convert.array_from_numpy(xs, self.mesh.flat[0])
        if xs.shape[0] > self.round_batch:
            raise ValueError(f"round takes at most {self.round_batch} "
                             f"images, got {xs.shape[0]}")
        if self.policy is not None:
            from repro_torch.occam.quant import casting
            xs = casting.quantize(xs, self.policy.boundary,
                                  self.policy.scale)
        flat = xs.reshape(xs.shape[0], -1)
        out = flat.new_zeros((self.round_batch, self.payload_width))
        out[:flat.shape[0], :flat.shape[1]] = flat
        return out.reshape(self.round_width, self.microbatch,
                           self.payload_width)


def stream(params: Sequence[dict], xs, net: NetSpec,
           partition: PartitionResult | Sequence[int], *,
           microbatch: int = 1, plan: StapPlan | None = None,
           stage_times: Sequence[float] | None = None,
           max_chips: int | None = None, max_replicas: int | None = None,
           target_period: float | None = None,
           mesh: DeviceMesh | None = None, devices: Sequence | None = None,
           counter: cnn.TrafficCounter | None = None
           ) -> tuple[torch.Tensor, StapPipeline]:
    """One-shot convenience wrapper: build the pipeline and stream ``xs``.

    Returns ``(y, pipeline)`` — keep the pipeline object to stream more
    batches, or read ``pipeline.report()``.
    """
    pipe = StapPipeline(net, partition, xs.shape[0], microbatch, plan=plan,
                        stage_times=stage_times, max_chips=max_chips,
                        max_replicas=max_replicas,
                        target_period=target_period, mesh=mesh,
                        devices=devices)
    return pipe.run(params, xs, counter=counter), pipe

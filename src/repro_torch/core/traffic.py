"""Analytical off-chip traffic / performance / energy models (paper §IV-V).

Three schemes, accounted exactly as the paper does (elements, per image):

* **base**  — layer-by-layer (Eyeriss-like): every layer reads its input map
  and writes its output map off-chip; filters are re-fetched once per layer
  per image (no cross-image residence). Captures k*k*n input reuse but no
  inter-layer reuse.
* **layer_fusion** — Occam's partitions (their exhaustive search is
  infeasible; §IV uses our partitions for LF too) with *square* tiles.
  Boundary traffic equals Occam's; sub-optimal tiles show up as
  *recomputation* (instruction bloat), not extra misses — Table III.
* **occam** — DP-optimal partitions, full-row tiles, chip-resident filters
  amortized to zero over the image stream: traffic = span boundary maps only.

Performance/energy first-order models reproduce Fig. 8/9's structure:
latency ~ max(compute_time, memory_time) per scheme on the scaled
accelerator; energy = compute_ops * e_mac + offchip_bytes * e_dram +
boundary_bytes * e_pcie.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .closure import max_square_tile, max_tile_rows, recompute_factor_square
from .graph import NetSpec
from .partition import PartitionResult, partition_cnn, partition_transfers


@dataclasses.dataclass
class TrafficCounter:
    """Mutable off-chip transfer accumulator, shared by every execution
    engine (interpreted / scan / pallas / STAP pipeline) so model==machine
    checks are engine-independent. Formerly ``repro.models.cnn
    .TrafficCounter``; the name there remains as an alias."""

    reads: int = 0
    writes: int = 0
    # byte twins: what the same transfers weigh on the wire. Engines
    # maintain them through add_reads/add_writes with the plan's dtype
    # width; fp32 paths keep bytes == 4 x elems exactly.
    read_bytes: float = 0.0
    write_bytes: float = 0.0

    @property
    def total(self) -> int:
        return self.reads + self.writes

    @property
    def total_bytes(self) -> float:
        return self.read_bytes + self.write_bytes

    def add_reads(self, elems: int, bytes_per_elem: float = 4.0) -> None:
        self.reads += elems
        self.read_bytes += elems * bytes_per_elem

    def add_writes(self, elems: int, bytes_per_elem: float = 4.0) -> None:
        self.writes += elems
        self.write_bytes += elems * bytes_per_elem

    def add_scaled(self, per_image: "TrafficCounter", images: int) -> None:
        """Masked-lane accounting: accumulate ``images`` valid images'
        worth of a per-image transfer profile. Serving sessions pad ragged
        traffic into fixed rounds; the padded (masked) lanes move no real
        data and must not inflate ``measured_*`` — so sessions count
        ``per_image x valid lanes`` instead of ``per_span x round size``."""
        self.reads += per_image.reads * images
        self.writes += per_image.writes * images
        self.read_bytes += per_image.read_bytes * images
        self.write_bytes += per_image.write_bytes * images


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """One unified traffic object: the analytical per-image prediction,
    optionally carrying what an execution actually measured.

    The first five fields are the paper's per-image model (always set).
    ``measured_reads`` / ``measured_writes`` / ``images`` are populated by
    :meth:`with_measured` from a :class:`TrafficCounter` after a run —
    measured vs predicted live in one object, so ``matches_prediction``
    is the model==machine check."""

    scheme: str
    feature_elems: float   # off-chip feature-map elements moved / image
    filter_elems: float    # off-chip filter elements moved / image
    compute_macs: float    # MACs / image (recompute included)
    boundary_elems: float  # chip-to-chip (PCIe/ICI) elements / image
    measured_reads: float | None = None   # counted over ``images`` images
    measured_writes: float | None = None
    images: int | None = None
    # queue-side serving state (a repro.occam.deploy.ServingStats), set by
    # Session.report(); plans/batch runs leave it None
    serving: object | None = None
    # wall-clock tick window (a dict: tick_mean_s / tick_count /
    # tick_busy_fraction), set by Deployment.report() / Session.report()
    # when the serving runtime has timed ticks; None otherwise
    timing: object | None = None
    # byte-denominated twins (dtype-aware accounting): per-elem widths of
    # the two off-chip data classes. fp32 (the historical implicit dtype)
    # is 4.0/4.0, making every *_bytes property exactly 4 x its elem
    # twin; a plan with a quant policy stamps the policy's widths here.
    boundary_bytes_per_elem: float = 4.0
    filter_bytes_per_elem: float = 4.0
    measured_read_bytes: float | None = None
    measured_write_bytes: float | None = None

    @property
    def offchip_elems(self) -> float:
        return self.feature_elems + self.filter_elems

    # --- byte twins ----------------------------------------------------
    @property
    def feature_bytes(self) -> float:
        """Feature maps cross DRAM in the *boundary* dtype."""
        return self.feature_elems * self.boundary_bytes_per_elem

    @property
    def filter_bytes(self) -> float:
        return self.filter_elems * self.filter_bytes_per_elem

    @property
    def offchip_bytes(self) -> float:
        return self.feature_bytes + self.filter_bytes

    @property
    def boundary_bytes(self) -> float:
        return self.boundary_elems * self.boundary_bytes_per_elem

    @property
    def measured_elems(self) -> float | None:
        if self.measured_reads is None:
            return None
        return self.measured_reads + self.measured_writes

    @property
    def measured_bytes(self) -> float | None:
        if self.measured_read_bytes is None:
            return None
        return self.measured_read_bytes + self.measured_write_bytes

    @property
    def measured_per_image(self) -> float | None:
        if self.measured_elems is None or not self.images:
            return None
        return self.measured_elems / self.images

    @property
    def measured_bytes_per_image(self) -> float | None:
        if self.measured_bytes is None or not self.images:
            return None
        return self.measured_bytes / self.images

    @property
    def matches_prediction_bytes(self) -> bool | None:
        """model == machine in *bytes*: the dtype-weighted measurement
        equals the dtype-weighted prediction. ``None`` until a byte
        measurement is attached."""
        per_image = self.measured_bytes_per_image
        if per_image is None:
            return None
        return math.isclose(per_image, self.offchip_bytes, rel_tol=1e-9)

    @property
    def matches_prediction(self) -> bool | None:
        """model == machine: measured per-image off-chip traffic equals the
        prediction — in elements, and (when a byte measurement is
        attached) in bytes too, so mixed-dtype runs cannot pass on elem
        counts while shipping the wrong widths. ``None`` until a
        measurement is attached."""
        per_image = self.measured_per_image
        if per_image is None:
            return None
        ok = math.isclose(per_image, self.offchip_elems, rel_tol=1e-9)
        in_bytes = self.matches_prediction_bytes
        if in_bytes is not None:
            ok = ok and in_bytes
        return ok

    def with_measured(self, counter: TrafficCounter,
                      images: int) -> "TrafficReport":
        """Attach a run's counted transfers (over ``images`` images).
        Counters that only tracked elements (no byte twins) are taken as
        fp32: bytes = 4 x elems."""
        rb, wb = counter.read_bytes, counter.write_bytes
        if rb == 0.0 and wb == 0.0 and counter.total:
            rb, wb = counter.reads * 4.0, counter.writes * 4.0
        return dataclasses.replace(self, measured_reads=counter.reads,
                                   measured_writes=counter.writes,
                                   measured_read_bytes=rb,
                                   measured_write_bytes=wb,
                                   images=images)


def base_traffic(net: NetSpec, batch: int = 1) -> TrafficReport:
    """Layer-by-layer base case (per image). Filters are re-fetched once per
    layer *per image* — §II-B: 'each layer's filters have to be refetched
    for the next image (i.e., no cross-image reuse as captured by Occam)'.
    ``batch`` divides nothing here; it is accepted for API symmetry."""
    del batch
    feat = 0.0
    for l in range(net.n_layers):
        feat += net.map_elems(l) + net.map_elems(l + 1)
    # Residual reads: each edge (s, t) re-reads L_s at layer t (2*l + r).
    for (s, _t) in net.residual_edges:
        feat += net.map_elems(s)
    filt = float(net.total_weight_elems())
    return TrafficReport("base", feat, filt, float(net.total_macs()), 0.0)


def occam_traffic(net: NetSpec, capacity_elems: int, batch: int = 1,
                  partition: PartitionResult | None = None,
                  policy: object = None) -> TrafficReport:
    """DP-optimal spans; off-chip only at span boundaries; filters amortized
    to ~0 (asymptotic chip residence). Boundary maps also cross chips.
    ``policy`` (a ``repro.occam.quant.DtypePolicy``) stamps the report's
    per-elem byte widths and steers the DP's byte-denominated fits."""
    part = partition or partition_cnn(net, capacity_elems, batch,
                                      policy=policy)
    # Score the boundary set with the canonical per-image formula rather
    # than trusting ``part.transfers`` — a partition may have been chosen
    # under another cost mode (e.g. "hops" for pipeline link traffic),
    # but its DRAM prediction is a function of the boundaries alone.
    # Oversized single layers (lower-bound mode) spill their own io anyway —
    # already counted by the DP base case.
    feat = partition_transfers(net, part.boundaries, batch=1)
    widths = {}
    if policy is not None:
        widths = {"boundary_bytes_per_elem": policy.boundary_bytes,
                  "filter_bytes_per_elem": policy.weight_bytes}
    return TrafficReport("occam", feat, 0.0, float(net.total_macs()),
                         feat / 2, **widths)


def layer_fusion_traffic(net: NetSpec, capacity_elems: int, batch: int = 1,
                         partition: PartitionResult | None = None) -> TrafficReport:
    """Layer Fusion on Occam's partitions with maximal square tiles.

    Misses ~= Occam's (recompute instead of refetch, §V-B1); compute is
    bloated by the per-span halo recompute factor."""
    part = partition or partition_cnn(net, capacity_elems, batch)
    feat = partition_transfers(net, part.boundaries, batch=1)
    macs = 0.0
    for sp in part.spans:
        t = max_square_tile(net, sp.start, sp.end, capacity_elems, batch)
        exact = sum(net.layers[l].macs for l in range(sp.start, sp.end))
        if t <= 0:
            macs += exact  # degenerate: tile can't fit; fall back to exact
            continue
        macs += exact * recompute_factor_square(net, sp.start, sp.end, t)
    return TrafficReport("layer_fusion", feat, 0.0, macs, feat / 2)


# --------------------------------------------------------------------------
# First-order performance & energy models (Fig. 8 / Fig. 9)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineModel:
    """The paper's scaled single-inference slice (Table I) by default."""

    macs_per_sec: float = 15_000 * 1.0e9             # 15K MAC units @ ~1 GHz
                                                     # (paper's scaled slice)
    mem_bytes_per_sec: float = 133e9                 # 133 GB/s peak
    mem_efficiency: float = 0.5                      # achieved/peak DRAM bw on
                                                     # conv streams (calibrated
                                                     # like the paper's slice)
    bytes_per_elem: float = 1.0                      # INT8
    e_mac_pj: float = 0.43                           # TPU compute energy [22]
    e_dram_pj_per_byte: float = 48.0                 # GDDR5 6 pJ/bit [32]
    e_link_pj_per_byte: float = 48.0                 # PCIe ~ DRAM cost/bit [42]
    instr_overhead: dict | None = None               # scheme -> bloat factor


def latency_model(report: TrafficReport, m: MachineModel,
                  instr_factor: float = 1.0) -> float:
    """Roofline-style: the slower of compute and memory streams."""
    t_compute = report.compute_macs * instr_factor / m.macs_per_sec
    t_mem = (report.offchip_elems * m.bytes_per_elem
             / (m.mem_bytes_per_sec * m.mem_efficiency))
    return max(t_compute, t_mem)


def energy_model(report: TrafficReport, m: MachineModel,
                 instr_factor: float = 1.0) -> dict:
    compute = report.compute_macs * instr_factor * m.e_mac_pj
    dram = report.offchip_elems * m.bytes_per_elem * m.e_dram_pj_per_byte
    link = report.boundary_elems * m.bytes_per_elem * m.e_link_pj_per_byte
    return {"compute_pj": compute, "dram_pj": dram, "link_pj": link,
            "total_pj": compute + dram + link}


def compare_schemes(net: NetSpec, capacity_elems: int, batch: int = 1,
                    machine: MachineModel | None = None) -> dict:
    """Full per-network comparison: traffic, speedups, energy (E2-E5)."""
    m = machine or MachineModel()
    part = partition_cnn(net, capacity_elems, batch)
    base = base_traffic(net, batch)
    occ = occam_traffic(net, capacity_elems, batch, part)
    lf = layer_fusion_traffic(net, capacity_elems, batch, part)

    # Instruction bloat: Occam's loop overhead is small (paper: 1.03-1.05);
    # LF's recompute is intrinsic to its tiles (already folded into macs).
    occ_instr = 1.04
    t_base = latency_model(base, m)
    t_occ = latency_model(occ, m, occ_instr)
    t_lf = latency_model(lf, m)
    e_base = energy_model(base, m)
    e_occ = energy_model(occ, m, occ_instr)
    e_lf = energy_model(lf, m)
    return {
        "partition": part,
        "traffic": {"base": base, "occam": occ, "layer_fusion": lf},
        "traffic_reduction_occam": base.offchip_elems / max(occ.offchip_elems, 1e-9),
        "traffic_reduction_lf": base.offchip_elems / max(lf.offchip_elems, 1e-9),
        "speedup_occam": t_base / t_occ,
        "speedup_lf": t_base / t_lf,
        "speedup_occam_vs_lf": t_lf / t_occ,
        "norm_instr": {"occam": occ_instr,
                       "layer_fusion": lf.compute_macs / base.compute_macs},
        "norm_miss": {"occam": occ.offchip_elems / base.offchip_elems,
                      "layer_fusion": lf.offchip_elems / base.offchip_elems},
        "energy": {"base": e_base, "occam": e_occ, "layer_fusion": e_lf},
        "energy_saving_occam": 1.0 - e_occ["total_pj"] / e_base["total_pj"],
        "energy_saving_lf": 1.0 - e_lf["total_pj"] / e_base["total_pj"],
    }


def geomean(xs: Sequence[float]) -> float:
    xs = [max(x, 1e-12) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))

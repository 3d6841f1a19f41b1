"""Declarative hardware model for fleet-aware planning (``occam.Fleet``).

Occam's DP guarantees least off-chip traffic *for a given on-chip
capacity* (paper §III-C/D) and STAP picks replicas *for a given stage-time
profile* (§III-E) — both are functions of the machine, not free knobs. A
:class:`Fleet` states what the machine actually is: how many chips there
are, how much on-chip (VMEM) capacity each holds, and optionally the
bandwidths that bound the roofline. ``occam.autoplan(net, fleet)``
derives capacity and placement from it instead of asking the caller to
hand-feed ``capacity_elems=`` / ``chips=`` / ``replicas=``.

Fleets are JSON documents like plans are: ``to_json`` / ``save`` /
``load_fleet`` ship the hardware description to wherever planning runs,
and plan schema v3 embeds the fleet a plan was searched under.

Sizes are in *elements* (dtype-agnostic, as everywhere in ``repro.core``);
rates are elements (or MACs) per second.
"""
from __future__ import annotations

import dataclasses
import json

# The paper's scaled single-inference slice (Table I): 15K MAC units at
# ~1 GHz. Stage-time models count MACs; this converts them to seconds so
# optional bandwidth bounds (elements/s) compose on one axis.
DEFAULT_MACS_PER_S = 15_000 * 1.0e9


@dataclasses.dataclass(frozen=True)
class Fleet:
    """The hardware a deployment will actually run on.

    ``chips``: devices available — a STAP placement of S stages with
    replica vector r occupies an S x max(r) mesh, which must fit here.
    ``vmem_elems``: per-chip on-chip capacity in elements — the DP's C;
    ``autoplan`` sweeps the candidate dependence-closure thresholds up to
    it. ``link_elems_per_s`` / ``hbm_elems_per_s``: optional inter-chip
    and off-chip bandwidths; when given, candidate periods are
    roofline-bounded by boundary-payload and off-chip traffic.
    ``macs_per_s``: per-chip compute rate used to put the MAC-count stage
    model in seconds (default: the paper's scaled slice).
    ``dtype_policy``: the dtype axis ``autoplan`` sweeps — ``None`` (the
    implicit fp32 policy), a preset name (``"int8"``), an
    ``occam.quant.DtypePolicy`` (or its dict form), or a sequence of
    those: each policy runs its own byte-denominated capacity sweep and
    the Pareto frontier trades the candidates' traffic bytes against
    accuracy headroom (``quant_cost``).
    """

    chips: int
    vmem_elems: int
    link_elems_per_s: float | None = None
    hbm_elems_per_s: float | None = None
    macs_per_s: float = DEFAULT_MACS_PER_S
    dtype_policy: object = None

    def __post_init__(self) -> None:
        if self.chips < 1:
            raise ValueError("a fleet needs at least one chip")
        if self.vmem_elems < 1:
            raise ValueError("vmem_elems must be positive")
        for field in ("link_elems_per_s", "hbm_elems_per_s"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"{field} must be positive when given")
        if self.macs_per_s <= 0:
            raise ValueError("macs_per_s must be positive")
        # fail fast on an unresolvable policy spec (quant.policy is as
        # dependency-free as this module — no jax behind the import)
        from .quant import resolve_policies

        resolve_policies(self.dtype_policy)

    def max_replicas(self, n_stages: int, packing: str = "rect") -> int:
        """Widest replica axis an ``n_stages``-stage pipeline can hold
        here (0 when the fleet cannot host the pipeline at all).

        ``packing="rect"`` is the rectangular ``n_stages x r`` mesh
        bound; ``packing="sum"`` is the §III-E sum-of-replicas packing
        (``occam.calibrate.placement``), where the widest single stage
        can take every chip the other stages leave over."""
        if packing == "sum":
            return max(0, self.chips - n_stages + 1) \
                if n_stages >= 1 else 0
        return self.chips // n_stages

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "chips": self.chips,
            "vmem_elems": self.vmem_elems,
            "link_elems_per_s": self.link_elems_per_s,
            "hbm_elems_per_s": self.hbm_elems_per_s,
            "macs_per_s": self.macs_per_s,
        }
        # written only when set, so pre-quant readers of fleet documents
        # (and the plan schema's embedded fleet blocks) see no new key
        if self.dtype_policy is not None:
            d["dtype_policy"] = _policy_spec_to_json(self.dtype_policy)
        return d

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "Fleet":
        return cls(
            chips=int(d["chips"]),
            vmem_elems=int(d["vmem_elems"]),
            link_elems_per_s=(None if d.get("link_elems_per_s") is None
                              else float(d["link_elems_per_s"])),
            hbm_elems_per_s=(None if d.get("hbm_elems_per_s") is None
                             else float(d["hbm_elems_per_s"])),
            macs_per_s=float(d.get("macs_per_s", DEFAULT_MACS_PER_S)),
            dtype_policy=d.get("dtype_policy"),
        )

    @classmethod
    def from_json(cls, doc: str) -> "Fleet":
        return cls.from_dict(json.loads(doc))


def _policy_spec_to_json(spec):
    """A JSON-serializable form of a ``dtype_policy`` spec: preset names
    stay names, policies become their dict form, sequences map through.
    ``Fleet.from_dict`` round-trips the JSON form directly —
    ``occam.quant.resolve_policies`` accepts every shape produced here."""
    if spec is None or isinstance(spec, (str, dict)):
        return spec
    if hasattr(spec, "to_dict"):
        return spec.to_dict()
    return [_policy_spec_to_json(item) for item in spec]


def load_fleet(path: str) -> Fleet:
    with open(path) as f:
        return Fleet.from_json(f.read())

"""Per-span dtype policy: the planning-side description of quantization.

Occam's capacity game is byte-denominated on real chips — int8
activations quadruple effective VMEM over fp32 and quarter every
boundary payload — but the planner historically counted fp32 elements.
:class:`DtypePolicy` names the three dtype axes that matter to the
planner (resident weights, in-span activations, and the boundary
transport between spans) plus the per-tensor scale an integer boundary
carries. The policy is a *plan-level* artifact: it rides in the plan's
optional schema-v5 ``quant`` block, scales the DP's footprints and
boundary charges (``core.partition``), and tells the runtime which
dtype the ring buffers and ``ppermute`` payloads use.

This module is planning-side and dependency-free (no jax) — the casting
twins live in :mod:`repro.occam.quant.casting`.
"""
from __future__ import annotations

import dataclasses

QUANT_FORMAT_VERSION = 1

# planner-visible byte widths; fp32 is the 4-byte reference unit every
# elem-denominated quantity in the repo historically assumed
DTYPE_BYTES = {
    "float32": 4.0,
    "bfloat16": 2.0,
    "float16": 2.0,
    "int8": 1.0,
}

FP32_BYTES = DTYPE_BYTES["float32"]

# integer dtypes carry a per-tensor scale and compute in fp32
_INT_DTYPES = ("int8",)


def dtype_bytes(name: str) -> float:
    """Bytes per element of a policy dtype name."""
    try:
        return DTYPE_BYTES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy dtype {name!r}; known: {sorted(DTYPE_BYTES)}")


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Dtypes for a plan's three data classes, plus the int8 scale.

    ``weights`` is the dtype resident filters occupy on chip;
    ``activations`` the dtype in-span feature rows occupy in the
    closure rings; ``boundary`` the dtype span-boundary maps are
    written to DRAM / shipped over the interconnect in. ``scale`` is
    the per-tensor symmetric quantization step for integer dtypes
    (``q = round(clip(x / scale, -127, 127))``); it is ignored for
    float dtypes."""

    weights: str = "float32"
    activations: str = "float32"
    boundary: str = "float32"
    scale: float = 0.05

    def __post_init__(self) -> None:
        for field in ("weights", "activations", "boundary"):
            dtype_bytes(getattr(self, field))
        if self.scale <= 0:
            raise ValueError("scale must be positive")

    # --- planner-side byte widths ---------------------------------
    @property
    def weight_bytes(self) -> float:
        return dtype_bytes(self.weights)

    @property
    def activation_bytes(self) -> float:
        return dtype_bytes(self.activations)

    @property
    def boundary_bytes(self) -> float:
        return dtype_bytes(self.boundary)

    @property
    def is_default(self) -> bool:
        """True when the policy is the implicit all-fp32 one."""
        return (self.weights == self.activations == self.boundary
                == "float32")

    @property
    def compute(self) -> str:
        """The dtype span cores run in: integer activations dequantize
        to fp32 at span entry (the engines' numeric dtype); float
        activations compute natively."""
        if self.activations in _INT_DTYPES:
            return "float32"
        return self.activations

    @property
    def quant_cost(self) -> int:
        """Ordinal accuracy-headroom cost (0 = exact fp32). The Pareto
        frontier keeps one candidate per cost level alive, so cheaper
        traffic never silently evicts the full-precision plan."""
        order = {"float32": 0, "bfloat16": 1, "float16": 1, "int8": 2}
        return max(order[self.weights], order[self.activations],
                   order[self.boundary])

    # --- serialization (the plan's schema-v5 ``quant`` block) -----
    def to_dict(self) -> dict:
        return {
            "version": QUANT_FORMAT_VERSION,
            "weights": self.weights,
            "activations": self.activations,
            "boundary": self.boundary,
            "scale": self.scale,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DtypePolicy":
        v = d.get("version", QUANT_FORMAT_VERSION)
        if v > QUANT_FORMAT_VERSION:
            raise ValueError(f"quant block version {v} is newer than "
                             f"supported {QUANT_FORMAT_VERSION}")
        return cls(weights=str(d.get("weights", "float32")),
                   activations=str(d.get("activations", "float32")),
                   boundary=str(d.get("boundary", "float32")),
                   scale=float(d.get("scale", 0.05)))


# named presets: the sweep axis ``Fleet(dtype_policy=...)`` accepts
POLICIES = {
    "fp32": DtypePolicy(),
    "bf16": DtypePolicy(weights="bfloat16", activations="bfloat16",
                        boundary="bfloat16"),
    # weights stay fp32-resident (GPTQ-style weights-only quant is the
    # other direction); the traffic story is the activation boundary
    "int8": DtypePolicy(weights="float32", activations="int8",
                        boundary="int8"),
}


def resolve_policy(spec) -> "DtypePolicy | None":
    """One policy from a name / DtypePolicy / None."""
    if spec is None or isinstance(spec, DtypePolicy):
        return spec
    if isinstance(spec, str):
        try:
            return POLICIES[spec]
        except KeyError:
            raise ValueError(f"unknown dtype policy {spec!r}; "
                             f"named policies: {sorted(POLICIES)}")
    if isinstance(spec, dict):
        return DtypePolicy.from_dict(spec)
    raise TypeError(f"cannot resolve a DtypePolicy from {type(spec)!r}")


def resolve_policies(spec) -> list:
    """The sweep list for ``autoplan``: None -> [None] (implicit fp32);
    a single name/policy -> that one; a sequence -> each resolved, with
    the implicit-fp32 entry preserved as None."""
    if spec is None:
        return [None]
    if isinstance(spec, (str, dict, DtypePolicy)):
        return [resolve_policy(spec)]
    out = []
    for item in spec:
        out.append(resolve_policy(item))
    if not out:
        return [None]
    return out

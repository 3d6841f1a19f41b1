"""``occam.quant`` — the planning side of dtype policies.

- :mod:`~repro_torch.occam.quant.policy` — :class:`DtypePolicy`, the
  named presets and the plan's schema-v5 ``quant`` block.
- :mod:`~repro_torch.occam.quant.footprint` — byte-denominated span
  footprints.

Executing a policy (the casting twins) is the quantized-spans slice of
the port; until it lands, ``occam.plan`` rejects a ``dtype_policy``.
"""
from .footprint import (  # noqa: F401
    effective_footprint_elems,
    report_widths,
    span_footprint_bytes,
)
from .policy import (  # noqa: F401
    DTYPE_BYTES,
    FP32_BYTES,
    POLICIES,
    QUANT_FORMAT_VERSION,
    DtypePolicy,
    dtype_bytes,
    resolve_policies,
    resolve_policy,
)

__all__ = [
    "DTYPE_BYTES",
    "FP32_BYTES",
    "POLICIES",
    "QUANT_FORMAT_VERSION",
    "DtypePolicy",
    "dtype_bytes",
    "effective_footprint_elems",
    "report_widths",
    "resolve_policies",
    "resolve_policy",
    "span_footprint_bytes",
]

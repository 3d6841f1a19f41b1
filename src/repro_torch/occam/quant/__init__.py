"""``occam.quant`` — the planning side of dtype policies.

- :mod:`~repro_torch.occam.quant.policy` — :class:`DtypePolicy`, the
  named presets and the plan's schema-v5 ``quant`` block.
- :mod:`~repro_torch.occam.quant.footprint` — byte-denominated span
  footprints.
- :mod:`~repro_torch.occam.quant.casting` — the quantize / dequantize /
  fake-quant twins the span engine calls at span boundaries, on tensors.
"""
from . import casting  # noqa: F401
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
    "casting",
    "dtype_bytes",
    "effective_footprint_elems",
    "report_widths",
    "resolve_policies",
    "resolve_policy",
    "span_footprint_bytes",
]

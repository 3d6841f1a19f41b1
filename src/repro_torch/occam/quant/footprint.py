"""Byte-denominated footprint accounting under a dtype policy.

The DP's fit question is physical: does the span's dependence closure
plus its resident filters fit the chip's VMEM *bytes*? With everything
fp32 those bytes are ``4 x elems`` and the repo's elem-denominated
capacities are exact. Under a mixed policy the two diverge — this
module owns the conversion, in both directions:

- :func:`span_footprint_bytes` — the byte twin of
  ``closure.span_footprint_elems`` under a policy;
- :func:`effective_footprint_elems` — the same bytes expressed in
  fp32-equivalent elements, which is what the DP compares against its
  elem-denominated ``capacity_elems`` (an int8 closure "shrinks" 4x
  rather than the capacity growing, so every existing capacity knob,
  threshold sweep, and serialized plan keeps its units).
"""
from __future__ import annotations

from repro_torch.core import closure

from .policy import FP32_BYTES, DtypePolicy


def span_footprint_bytes(net, i: int, j: int, out_rows: int = 1,
                         policy: "DtypePolicy | None" = None,
                         batch: int = 1) -> float:
    """Bytes span ``[i, j)`` occupies on chip under ``policy`` (fp32
    when ``policy`` is None): batched activation closure at the
    activation width plus resident weights at the weight width."""
    act = policy.activation_bytes if policy else FP32_BYTES
    wt = policy.weight_bytes if policy else FP32_BYTES
    return closure.span_footprint_bytes(net, i, j, out_rows=out_rows,
                                        act_bytes=batch * act,
                                        weight_bytes=wt)


def effective_footprint_elems(net, i: int, j: int, out_rows: int = 1,
                              policy: "DtypePolicy | None" = None,
                              batch: int = 1) -> float:
    """``span_footprint_bytes / 4``: the footprint in fp32-equivalent
    elements, comparable against elem-denominated capacities."""
    return span_footprint_bytes(net, i, j, out_rows=out_rows,
                                policy=policy, batch=batch) / FP32_BYTES


def report_widths(policy: "DtypePolicy | None") -> dict:
    """Per-elem byte widths a ``TrafficReport`` carries for ``policy``
    (all 4.0 for the implicit fp32 policy)."""
    if policy is None:
        return {"filter_bytes_per_elem": FP32_BYTES,
                "boundary_bytes_per_elem": FP32_BYTES}
    return {"filter_bytes_per_elem": policy.weight_bytes,
            "boundary_bytes_per_elem": policy.boundary_bytes}

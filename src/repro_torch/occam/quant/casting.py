"""Runtime casting twins of :class:`~repro_torch.occam.quant.policy
.DtypePolicy`, on tensors.

The planner talks in dtype *names* and byte widths; the engines need
actual casts. Three operations cover every hook site:

- :func:`quantize` — fp32 compute values -> the boundary/storage dtype
  (the form a map takes in device memory);
- :func:`dequantize` — storage dtype -> the span core's compute dtype;
- :func:`fake_quant` — the round trip in one call, for paths that keep
  fp32 buffers but must *see* the quantized values (the single-device
  executor's device-memory emulation, weight casting).

Integer quantization is per-tensor symmetric: ``q = round(clip(x /
scale, -127, 127))``, with ``torch.round`` rounding halves to even as
``jnp.round`` does. The round trip is idempotent — re-quantizing an
already-dequantized tensor reproduces the same codes — so a map pays the
rounding error exactly once.

The scale enters every product and quotient as a 0-d tensor of the
operand's dtype on the operand's device: a Python scalar would be read
in another precision (a bfloat16 product in fp32), or a CUDA division by
a host scalar turned into a product by its reciprocal, and the bits
would leave the reference's. ``torch.full`` makes it with a kernel, so
these casts are also legal inside a CUDA-graph capture.
"""
from __future__ import annotations

import torch

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a policy dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown policy dtype {name!r}; "
                         f"known: {sorted(_TORCH_DTYPES)}")


def _scalar(value: float, like: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=like.device)


def quantize(x: torch.Tensor, dtype: str, scale: float = 0.05
             ) -> torch.Tensor:
    """Cast compute values into the storage/transport dtype."""
    if dtype == "int8":
        q = torch.round(x / _scalar(scale, x, x.dtype))
        return torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return x.to(torch_dtype(dtype))


def dequantize(q: torch.Tensor, dtype: str, scale: float = 0.05,
               compute: str = "float32") -> torch.Tensor:
    """Cast storage/transport values back to the compute dtype."""
    out = torch_dtype(compute)
    if dtype == "int8":
        return q.to(out) * _scalar(scale, q, out)
    return q.to(out)


def fake_quant(x: torch.Tensor, dtype: str, scale: float = 0.05
               ) -> torch.Tensor:
    """Quantize-dequantize round trip, preserving ``x``'s dtype — the
    values a quantized buffer would hold, in an fp32-shaped buffer."""
    if dtype == "float32":
        return x
    restore = str(x.dtype).removeprefix("torch.")
    return dequantize(quantize(x, dtype, scale), dtype, scale,
                      compute=restore)


def quantize_params(params: list[dict], policy) -> list[dict]:
    """Apply the policy's *weight* dtype to per-layer params, keeping the
    storage dtype the engines expect (fake-quant: the numerics are the
    declared dtype's, the buffers stay the compute dtype)."""
    if policy is None or policy.weights == "float32":
        return params
    return [{k: fake_quant(v, policy.weights, policy.scale)
             for k, v in p.items()} for p in params]

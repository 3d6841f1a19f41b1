"""Move params and images into the port's tensors.

Params keep the reference package's structure: a list aligned with
``net.layers`` of ``{"w": (k, k, Cin, Cout), "b": (Cout,)}`` per conv and
``{}`` per pool — plain dicts, not ``nn.Module``s, because the span
engine slices them by layer index. Inputs may be numpy arrays (including
bfloat16 ones), anything ``numpy.asarray`` accepts, or tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def array_from_numpy(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """One array as a tensor on ``device`` (same dtype, same values)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # numpy extension type torch cannot read
        return torch.from_numpy(arr.astype(np.float32)).to(
            device, torch.bfloat16)
    # np.array copies: the tensor owns writable memory even when the
    # source is a read-only view (as numpy views of JAX arrays are)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(params, device: str | torch.device = "cpu"
                      ) -> list[dict]:
    """Per-layer param dicts with every array as a tensor on ``device``."""
    return [{name: array_from_numpy(v, device) for name, v in p.items()}
            for p in params]

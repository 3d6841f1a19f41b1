"""Public op: the multi-head Mamba-2 SSD scan, routed by the tensors'
device.

A CUDA tensor launches the hand-written kernel (``kernel.py``), which
reads each head's group by index and masks the ragged tail itself; a CPU
tensor runs its plain PyTorch version (``ref.ssd_scan_plain_call``), which
keeps the TPU kernel's per-chunk math. There is no fallback from one to
the other, and any other device raises.
"""
from __future__ import annotations

import torch

from .kernel import ssd_scan_cuda_call
from .ref import ssd_ref, ssd_scan_plain_call


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 64,
             state0: torch.Tensor | None = None, return_state: bool = False):
    """Multi-head SSD scan.

    x: (B, T, H, P) head values; a: (B, T, H) log decay per head and step
    (<= 0 for stability); b, c: (B, T, G, N) with H % G == 0 (groups
    broadcast like GQA). ``state0``: optional float32 (B, H, N, P) state
    before the first token. Returns y (B, T, H, P) in x's dtype, or
    ``(y, state)`` with the float32 (B, H, N, P) state after the last
    token when ``return_state``.

    ``chunk`` is the TPU kernel's chunk and the plain version's; the CUDA
    kernel walks chunks of its own (``kernel.CHUNK``). Neither changes
    the values beyond rounding.
    """
    h, g = x.shape[2], b.shape[2]
    if h % g:
        raise ValueError(f"H={h} not a multiple of G={g}")
    if x.device.type == "cuda":
        y, state = ssd_scan_cuda_call(x, a, b, c, state0=state0,
                                      return_state=return_state)
    elif x.device.type == "cpu":
        y, state = ssd_scan_plain_call(x, a, b, c, chunk=chunk,
                                       state0=state0,
                                       return_state=return_state)
    else:
        raise ValueError(f"no SSD-scan route for device {x.device}")
    return (y, state) if return_state else y


__all__ = ["ssd_ref", "ssd_scan", "ssd_scan_plain_call"]

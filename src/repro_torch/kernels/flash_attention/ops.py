"""Public op: GQA flash attention, routed by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernel.py``); a CPU
tensor runs its plain PyTorch version (``ref.flash_attention_plain_call``),
which keeps the TPU kernel's semantics. There is no fallback from one to
the other, and any other device raises.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda_call
from .ref import attention_ref, flash_attention_plain_call


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.

    GQA: query head h reads kv head ``h // (Hq // Hkv)`` by indexing, with
    no repeated copy on the kernel route. The causal mask is
    bottom-aligned. ``block_q``/``block_k`` are the TPU kernel's tile and
    are accepted for its signature: the CUDA kernel's tile is fixed and
    the plain version has none, and neither changes the values beyond
    rounding (the recurrence is exact).
    """
    del block_q, block_k
    hq, hkv = q.shape[1], k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if q.device.type == "cuda":
        call = flash_attention_cuda_call
    elif q.device.type == "cpu":
        call = flash_attention_plain_call
    else:
        raise ValueError(f"no flash-attention route for device {q.device}")
    return call(q, k, v, causal=causal)


__all__ = ["attention_ref", "flash_attention", "flash_attention_plain_call"]

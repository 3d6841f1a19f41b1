"""Plain PyTorch versions of the flash-attention kernel.

``attention_ref`` is the twin of the reference oracle
(``repro/kernels/flash_attention/ref.py::attention_ref``): exact fp32
softmax attention, GQA by repeating kv heads, causal mask
``tril(k=Skv - Sq)``.

``flash_attention_plain_call`` takes the CUDA kernel's arguments and keeps
the TPU kernel's own semantics (``repro/kernels/flash_attention/
kernel.py``), which differ from the oracle at the edges:

- the causal offset is ``max(seq_k_valid - seq_q_valid, 0)``: clamped, so
  with Sq > Skv query row r sees kv rows <= r (the oracle would mask the
  first ``Sq - Skv`` rows entirely);
- masked scores are ``NEG_INF = -1e30``, not ``-inf``;
- kv rows at or past ``seq_k_valid`` are masked;
- a row with no unmasked score (l == 0) gives 0.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0.

    fp32 softmax; returns (B, Hq, Sq, D) in q.dtype.
    """
    _, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def flash_attention_plain_call(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               seq_q_valid: int | None = None,
                               seq_k_valid: int | None = None
                               ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D). Query head h reads kv head
    ``h // (Hq // Hkv)``. Scores, softmax and the weighted sum are fp32;
    the output is (B, Hq, Sq, D) in q.dtype. The whole (Sq, Skv) score
    matrix of every head is materialized: this is a yardstick of values,
    not of speed.
    """
    _, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    sq_valid = sq if seq_q_valid is None else seq_q_valid
    sk_valid = sk if seq_k_valid is None else seq_k_valid
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (1.0 / math.sqrt(d)),
                     k.float())
    kv_ids = torch.arange(sk, device=q.device)[None, :]
    mask = kv_ids < sk_valid
    if causal:
        q_ids = torch.arange(sq, device=q.device)[:, None]
        mask = mask & (kv_ids <= q_ids + max(sk_valid - sq_valid, 0))
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return (o / torch.where(l == 0.0, 1.0, l)).to(q.dtype)

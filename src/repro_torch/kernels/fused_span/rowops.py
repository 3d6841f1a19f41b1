"""Row-plane compute of the plain fused-span loop (``ref.py``), which the
``scan`` engine (``repro_torch.models.cnn``) also runs.

Torch twins of the reference row math, with the batch dimension written
out: every function takes a leading batch axis ``B`` and a plain Python
row index (the schedule is static, so the loop that calls these is a
Python loop). The CUDA kernel (``csrc/fused_span.cu``) computes the same
rows element by element; the kernel-vs-plain checks compare against this.

Convs are k*k products ``(B*W_out, C_in) @ (C_in, C_out)`` over
horizontally shifted/strided row windows, accumulated in fp32. Pools are
k*k running maxima padded with ``NEG_INF`` (-1e30, not -inf).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def ring_window(ring: torch.Tensor, r: int, k: int, stride: int,
                padding: int, h_prev: int, cap: int,
                pad_val: float) -> torch.Tensor:
    """Gather the k input rows feeding output row ``r`` from a circular
    buffer ``ring`` (B, cap, W, C) holding the most recent ``cap`` rows of
    a (h_prev, W, C) map. Rows outside [0, h_prev) are synthesized padding
    (zero for conv, ``NEG_INF`` for pool). Returns (B, k, W, C)."""
    rows = []
    for dy in range(k):
        rr = r * stride - padding + dy
        if 0 <= rr < h_prev:
            rows.append(ring[:, rr % cap])
        else:
            rows.append(torch.full_like(ring[:, 0], pad_val))
    return torch.stack(rows, dim=1)


def conv_row(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             stride: int, padding: int, out_w: int) -> torch.Tensor:
    """One conv+ReLU output row from a (B, k, W_in, C_in) window.

    The window carries the exact vertical halo (already padded);
    horizontal same-padding is applied here. w: (k, k, C_in, C_out).
    Returns (B, out_w, C_out) in fp32.
    """
    k = w.shape[0]
    if padding:
        window = F.pad(window, (0, 0, padding, padding))
    acc = torch.zeros(window.shape[0], out_w, w.shape[-1],
                      dtype=torch.float32, device=window.device)
    span = stride * (out_w - 1) + 1
    wf = w.to(torch.float32)
    for dy in range(k):
        for dx in range(k):
            cols = window[:, dy, dx:dx + span:stride, :]
            acc += torch.matmul(cols.to(torch.float32), wf[dy, dx])
    return torch.relu(acc + b.to(torch.float32))


def pool_row(window: torch.Tensor, k: int, stride: int, padding: int,
             out_w: int) -> torch.Tensor:
    """One max-pool output row from a (B, k, W_in, C) window (vertical halo
    included, out-of-range rows already ``NEG_INF``). Returns
    (B, out_w, C) in the window's dtype."""
    if padding:
        window = F.pad(window, (0, 0, padding, padding), value=NEG_INF)
    span = stride * (out_w - 1) + 1
    acc = torch.full((window.shape[0], out_w, window.shape[-1]), NEG_INF,
                     dtype=window.dtype, device=window.device)
    for dy in range(k):
        for dx in range(k):
            acc = torch.maximum(acc, window[:, dy, dx:dx + span:stride, :])
    return acc


def project_row(src_row: torch.Tensor, w_t: int, c_t: int) -> torch.Tensor:
    """Parameter-free 'option A' residual shortcut for one row-plane:
    strided horizontal subsample + channel zero-pad/trim.
    src_row: (B, W_s, C_s) -> (B, w_t, c_t)."""
    w_s, c_s = src_row.shape[1:]
    sw = max(w_s // w_t, 1)
    y = src_row[:, ::sw, :][:, :w_t, :]
    if c_t > c_s:
        y = F.pad(y, (0, c_t - c_s))
    elif c_t < c_s:
        y = y[:, :, :c_t]
    return y

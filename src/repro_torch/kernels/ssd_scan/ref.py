"""Plain PyTorch versions of the SSD-scan kernel.

``ssd_ref`` is the twin of the reference oracle
(``repro/kernels/ssd_scan/ref.py::ssd_ref``): the sequential recurrence
``S_t = exp(a_t) S_{t-1} + B_t (x) x_t``, ``y_t = C_t^T S_t`` with an fp32
state, one step at a time.

``ssd_scan_plain_call`` takes the CUDA kernel's arguments and computes
the TPU kernel's per-chunk math (``repro/kernels/ssd_scan/kernel.py::
_ssd_kernel``) as a loop over chunks batched over (batch, head): groups
gathered to the heads and T padded with x = 0, a = 0 (decay 1), B = C = 0,
as ``ops.py`` does for the TPU kernel, plus the optional state in and out
that the model's prefill carries.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """x: (BH, T, P); a: (BH, T) log decay; b, c: (BH, T, N) ->
    (BH, T, P) in x's dtype. fp32 state."""
    bh, t, p = x.shape
    n = b.shape[-1]
    xf, af, bf, cf = (v.float() for v in (x, a, b, c))
    s = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        s = (torch.exp(af[:, i])[:, None, None] * s
             + bf[:, i, :, None] * xf[:, i, None, :])
        ys.append(torch.einsum("bn,bnp->bp", cf[:, i], s))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bh, 0, p))
    return y.to(x.dtype)


def _heads_first(v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, K) -> (B*H, T, K) in fp32."""
    bsz, t, h, k = v.shape
    return v.float().permute(0, 2, 1, 3).reshape(bsz * h, t, k)


def ssd_scan_plain_call(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, *, chunk: int = 64,
                        state0: torch.Tensor | None = None,
                        return_state: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's function in plain PyTorch, on any device.

    x: (B, T, H, P); a: (B, T, H); b, c: (B, T, G, N), H % G == 0; head h
    reads group ``h // (H // G)``. ``state0``: optional (B, H, N, P) state
    before the first token (zeros when None). All math in fp32. Returns
    ``(y, state)``: y (B, T, H, P) in x's dtype, and the float32
    (B, H, N, P) state after the last token when ``return_state``, else
    None.
    """
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"H={h} not a multiple of G={g}")
    rep = h // g
    xf = _heads_first(x)
    af = a.float().permute(0, 2, 1).reshape(bsz * h, t)
    bf = _heads_first(b.repeat_interleave(rep, dim=2))
    cf = _heads_first(c.repeat_interleave(rep, dim=2))
    pad = (-t) % chunk
    if pad:  # zero x adds nothing; a = 0 leaves the state undecayed
        xf, bf, cf = (F.pad(v, (0, 0, 0, pad)) for v in (xf, bf, cf))
        af = F.pad(af, (0, pad))
    if state0 is None:
        s = torch.zeros((bsz * h, n, p), dtype=torch.float32,
                        device=x.device)
    else:
        s = state0.float().reshape(bsz * h, n, p)
    rows = torch.arange(chunk, device=x.device)
    below = rows[:, None] >= rows[None, :]
    ys = []
    for start in range(0, t + pad, chunk):
        sl = slice(start, start + chunk)
        xb, ab, bb, cb = xf[:, sl], af[:, sl], bf[:, sl], cf[:, sl]
        a_cum = torch.cumsum(ab, dim=1)                       # A[i]
        seg = a_cum[:, :, None] - a_cum[:, None, :]           # A[i] - A[j]
        l_mat = torch.exp(seg.masked_fill(~below, float("-inf")))
        scores = (cb @ bb.transpose(1, 2)) * l_mat
        y = scores @ xb + torch.exp(a_cum)[..., None] * (cb @ s)
        a_tot = a_cum[:, -1:]
        w = torch.exp(a_tot - a_cum)[..., None] * bb          # (BH, Q, N)
        s = torch.exp(a_tot)[..., None] * s + w.transpose(1, 2) @ xb
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t] if ys else xf[:, :0]
    y = y.reshape(bsz, h, t, p).permute(0, 2, 1, 3).to(x.dtype)
    return y, (s.reshape(bsz, h, n, p) if return_state else None)

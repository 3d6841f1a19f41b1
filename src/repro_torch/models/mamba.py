"""Mamba-2 (SSD) block: chunked-scan prefill + O(1)-state decode, the
port of ``repro/models/mamba.py`` on one device.

Prefill's scan takes its implementation as an argument (``ssd_impl``):
``"kernel"`` calls ``kernels.ssd_scan.ops.ssd_scan``, which launches the
CUDA SSD-scan kernel on a CUDA tensor and runs its plain version on a CPU
tensor; ``"chunked"`` calls :func:`ssd_chunked`, the twin of the
reference's ``lax.scan`` over chunks. Decode is the single-step recurrence
on the cached state, as in the reference, and launches no kernel.

Separate in-projections per component (z, x, B, C, dt) keep the
reference's parameter names. The reference's ``shard`` calls and its
``jax.checkpoint`` around the chunk step are dropped: the port runs on one
device and has no backward yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan

from .layers import normal_init, rms_norm, row_parallel

SSD_IMPLS = ("kernel", "chunked")


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, conv_ch)
    state: torch.Tensor  # (B, G, rep, N, P) fp32


def init_mamba(generator: torch.Generator, d_model: int, ssm,
               dtype=torch.bfloat16) -> nn.ParameterDict:
    """Mamba parameters on ``generator``'s device, distributed as the
    reference's: N(0, 1/d_model) in-projections, N(0, 0.04) conv taps,
    N(0, 1/d_inner) out-projection; dt_bias and A_log 0, D 1 (fp32)."""
    di = ssm.d_inner(d_model)
    nh = ssm.n_ssm_heads(d_model)
    gn = ssm.n_groups * ssm.d_state
    conv_ch = di + 2 * gn
    dev = generator.device
    si = 1.0 / math.sqrt(d_model)

    def w(shape, std):
        return normal_init(generator, shape, std, dtype)

    return nn.ParameterDict({
        "wz": w((d_model, di), si),
        "wx": w((d_model, di), si),
        "wB": w((d_model, gn), si),
        "wC": w((d_model, gn), si),
        "wdt": w((d_model, nh), si),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "conv_w": w((ssm.d_conv, conv_ch), 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
        "wo": w((di, d_model), 1.0 / math.sqrt(di)),
    })


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d as K shift-MACs, then SiLU. x: (B, T, C),
    w: (K, C)."""
    k = w.shape[0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    acc = pad[:, k - 1:k - 1 + t] * w[k - 1]
    for j in range(1, k):
        acc = acc + pad[:, k - 1 - j:k - 1 - j + t] * w[k - 1 - j]
    return F.silu(acc + b)


def _ssd_chunk_step(state, xc, ac, bc, cc, chunk: int):
    """One chunk of the SSD scan. state: (B, G, R, N, P) fp32;
    xc: (B, Q, G, R, P); ac: (B, Q, G, R); bc, cc: (B, Q, G, N).

    Every product has two operands: the reference's three-operand
    einsums would, contracted naively, hold a (B, Q, Q, G, R, P) tensor
    (4.3 GB per chunk at Mamba2-1.3B's prefill)."""
    a_cum = torch.cumsum(ac, dim=1)                          # (B,Q,G,R)
    seg = a_cum[:, :, None] - a_cum[:, None, :]              # (B,Q,Q,G,R)
    q_i = torch.arange(chunk, device=xc.device)
    mask = (q_i[:, None] >= q_i[None, :])[None, :, :, None, None]
    l_mat = torch.where(mask, torch.exp(seg), 0.0)
    scores = torch.einsum("bqgn,bkgn->bqkg", cc, bc)         # (B,Q,Q,G)
    y = torch.einsum("bqkgr,bkgrp->bqgrp", scores[..., None] * l_mat, xc)
    # incoming state contribution
    y = y + torch.exp(a_cum)[..., None] * torch.einsum(
        "bqgn,bgrnp->bqgrp", cc, state)
    # state update
    a_tot = a_cum[:, -1]                                     # (B,G,R)
    decay_rem = torch.exp(a_tot[:, None] - a_cum)            # (B,Q,G,R)
    state = (torch.exp(a_tot)[..., None, None] * state
             + torch.einsum("bkgn,bkgrp->bgrnp", bc,
                            decay_rem[..., None] * xc))
    return state, y


def ssd_chunked(x, a, b, c, *, n_groups: int, chunk: int, state0=None):
    """x: (B,T,H,P) fp32; a: (B,T,H); b, c: (B,T,G,N). Returns (y, state)
    with state (B, G, R, N, P) fp32."""
    bsz, t, h, p = x.shape
    g = n_groups
    r = h // g
    n = b.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (t + pad) // chunk
    xg = x.reshape(bsz, nc, chunk, g, r, p)
    ag = a.reshape(bsz, nc, chunk, g, r)
    bg = b.reshape(bsz, nc, chunk, g, n)
    cg = c.reshape(bsz, nc, chunk, g, n)
    state = state0
    if state is None:
        state = torch.zeros((bsz, g, r, n, p), dtype=torch.float32,
                            device=x.device)
    ys = []
    for i in range(nc):
        state, y = _ssd_chunk_step(state, xg[:, i], ag[:, i], bg[:, i],
                                   cg[:, i], chunk)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, t + pad, h, p)[:, :t]
    return y, state


def mamba_sublayer(p, x: torch.Tensor, ssm, *, cache: SSMCache | None = None,
                   cache_pos=None, ssd_impl: str = "kernel"):
    """x: (B, T, D) -> (y, new_cache). Decode mode when T == 1 and a cache
    is given; otherwise prefill (into the cache when one is given).

    The cache is updated in place (the reference returns an updated copy)
    and returned as ``new_cache``.
    """
    del cache_pos  # the recurrence needs no position, as in the reference
    if ssd_impl not in SSD_IMPLS:
        raise ValueError(f"ssd_impl must be one of {SSD_IMPLS}, got "
                         f"{ssd_impl!r}")
    bsz, t, d = x.shape
    di = ssm.d_inner(d)
    nh = ssm.n_ssm_heads(d)
    g, n, ph = ssm.n_groups, ssm.d_state, ssm.head_dim
    gn = g * n
    r = nh // g

    z = x @ p["wz"]
    xb = x @ p["wx"]
    bp = x @ p["wB"]
    cp = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])

    conv_in = torch.cat([xb, bp, cp], dim=-1)  # (B, T, di + 2gn)
    decode = cache is not None and t == 1
    new_conv = None
    if decode:  # window = conv state + current token
        win = torch.cat([cache.conv, conv_in], dim=1)  # (B, K, C)
        y = torch.einsum("bkc,kc->bc", win.float(), p["conv_w"].float())
        conv_out = F.silu(y + p["conv_b"].float())[:, None].to(x.dtype)
        new_conv = win[:, 1:]
    else:
        conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
        if cache is not None:  # prefill: stash the tail window
            k = ssm.d_conv
            new_conv = conv_in[:, -(k - 1):]
            if t < k - 1:
                new_conv = F.pad(conv_in, (0, 0, k - 1 - t, 0))
    xb = conv_out[..., :di]
    bp = conv_out[..., di:di + gn].reshape(bsz, t, g, n)
    cp = conv_out[..., di + gn:].reshape(bsz, t, g, n)

    xh = xb.reshape(bsz, t, nh, ph).float()
    a = -torch.exp(p["A_log"]) * dt                   # (B,T,H) log decay
    x_in = xh * dt[..., None]

    if decode:  # one recurrence step on the cached state
        s_prev = cache.state                          # (B,G,R,N,P)
        ar = a[:, 0].reshape(bsz, g, r)
        xr = x_in[:, 0].reshape(bsz, g, r, ph)
        b0 = bp[:, 0].float()                         # (B,G,N)
        c0 = cp[:, 0].float()
        new_state = (torch.exp(ar)[..., None, None] * s_prev
                     + torch.einsum("bgn,bgrp->bgrnp", b0, xr))
        y = torch.einsum("bgn,bgrnp->bgrp", c0,
                         new_state).reshape(bsz, 1, nh, ph)
    elif ssd_impl == "kernel":
        state0 = None if cache is None else cache.state.reshape(
            bsz, nh, n, ph)
        y, new_state = ssd_scan(x_in, a, bp.float(), cp.float(),
                                chunk=ssm.chunk, state0=state0,
                                return_state=True)
        new_state = new_state.reshape(bsz, g, r, n, ph)
    else:
        y, new_state = ssd_chunked(
            x_in, a, bp.float(), cp.float(), n_groups=g, chunk=ssm.chunk,
            state0=None if cache is None else cache.state)
    y = y + p["D"][:, None] * xh
    y = y.reshape(bsz, t, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], 1e-5)
    out = row_parallel(y, p["wo"])
    if cache is None:
        return out, None
    cache.conv.copy_(new_conv)
    cache.state.copy_(new_state)
    return out, cache


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMCache:
    """Zeroed conv window in ``dtype`` and fp32 state, as the reference's."""
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    gn = ssm.n_groups * ssm.d_state
    nh = ssm.n_ssm_heads(d)
    r = nh // ssm.n_groups
    return SSMCache(
        conv=torch.zeros((batch, ssm.d_conv - 1, di + 2 * gn), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, ssm.n_groups, r, ssm.d_state,
                           ssm.head_dim), dtype=torch.float32,
                          device=device),
    )

"""Capacity-based top-k MoE FFN on one device: the port of
``repro/models/moe.py``.

Both of the reference's single-device paths are here and share the
routing math: softmax over the experts, top-k, weights renormalised over
the k picks, a token's position in each expert's queue by an exclusive
cumsum, drops past the capacity C = ceil(T * k / E * capacity_factor),
and the Switch load-balance and router z losses.

- ``impl="local"`` (the default): the whole batch is one token group
  (T = B * S tokens, one capacity), all experts local.
- ``impl="gspmd_scatter"``: one group per sequence (capacity from S),
  the reference's pure-GSPMD formulation, which also runs on one device
  there. It is kept as a twin of the reference's API; the model's layers
  always take ``"local"``.

JAX's ``mode="drop"`` scatters drop out-of-range indices silently;
``index_put_``/``index_add_`` raise on them. So a dropped (expert,
position) pair is sent to one extra dump slot past the E * C real ones,
and a slot no token fills points at an extra sentinel row past the T
real tokens; both extras are sliced off. Shapes depend only on the
capacity, a Python int: the layer makes no host sync (no ``nonzero``,
no boolean-mask indexing, no ``.item()``).

The reference's production path, ``impl="ep_shard_map"`` (experts
sharded over a mesh's model axis inside ``shard_map``), needs the mesh
modules and raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import normal_init

IMPLS = ("local", "gspmd_scatter")


def init_moe(generator: torch.Generator, d_model: int, moe_cfg,
             dtype=torch.bfloat16) -> nn.ParameterDict:
    """MoE parameters on ``generator``'s device, distributed as the
    reference's: the router (d, E) N(0, 1/d) in fp32 whatever ``dtype``;
    w1, w3 (E, d, F) N(0, 1/d) and w2 (E, F, d) N(0, 1/F) in ``dtype``."""
    e, f = moe_cfg.n_experts, moe_cfg.d_ff_expert
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(f)
    return nn.ParameterDict({
        "router": normal_init(generator, (d_model, e), si, torch.float32),
        "w1": normal_init(generator, (e, d_model, f), si, dtype),
        "w3": normal_init(generator, (e, d_model, f), si, dtype),
        "w2": normal_init(generator, (e, f, d_model), so, dtype),
    })


def capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    return max(1, math.ceil(tokens * top_k / n_experts * factor))


def _route(x: torch.Tensor, router: torch.Tensor, e: int, k: int):
    """Routing math. x: (T, D), or (G, T, D) for G groups routed at once.
    Returns (w, idx, pos, (lb_loss, z_loss)) with w, idx and pos
    (..., T, K): positions count within each group, the losses average
    over every token.

    The logits are fp32 from x and the router in x's dtype, as the
    reference's ``preferred_element_type=f32`` contraction: in bf16 the
    products are exact in fp32, so both are upcast (a bf16 matmul would
    round the logits to bf16 and tie the top-k)."""
    logits = x.float() @ router.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.reshape(-1, e).mean(dim=0)
    # the top-k experts of a token are distinct: one 1 per pick
    counts = torch.zeros_like(probs, dtype=torch.int32).scatter_(-1, idx, 1)
    ce = counts.reshape(-1, e).float().mean(dim=0) / k
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    # position-in-expert: exclusive cumsum over the group's tokens
    base = torch.cumsum(counts, dim=-2) - counts
    pos = torch.gather(base, -1, idx)
    return w, idx, pos, (lb_loss, z_loss)


def _expert_ffn(xg, w1, w3, w2):
    """SwiGLU per expert: xg (..., E, C, D) -> (..., E, C, D)."""
    h = nn.functional.silu(torch.einsum("...ecd,edf->...ecf", xg, w1))
    h = h * torch.einsum("...ecd,edf->...ecf", xg, w3)
    return torch.einsum("...ecf,efd->...ecd", h, w2)


def _dispatch_combine(x, w, idx, pos, w1, w3, w2, *, c: int):
    """Gather each group's routed tokens into (G, E, C, D) slots, run the
    experts, scatter-add the weighted outputs back.

    x: (G, T, D); w, idx, pos: (G, T, K). Pairs past the capacity go to
    the dump slot E * C; empty slots hold the sentinel token T, which
    gathers row T - 1 (weight 0, as the reference clips it) and adds into
    an extra row T, sliced off. Returns (G, T, D)."""
    g, t, d = x.shape
    e = w1.shape[0]
    n_slots = e * c
    slot = torch.where(pos < c, idx * c + pos, n_slots)
    slot = slot.reshape(g, -1)
    t_idx = torch.arange(t, device=x.device)[:, None].expand(t, idx.shape[-1])
    src = torch.full((g, n_slots + 1), t, dtype=torch.int64, device=x.device)
    src = src.scatter_(1, slot, t_idx.reshape(1, -1).expand(g, -1))[:, :-1]
    wslot = torch.zeros((g, n_slots + 1), dtype=torch.float32,
                        device=x.device)
    wslot = wslot.scatter_(1, slot, w.reshape(g, -1))[:, :-1]
    group = torch.arange(g, device=x.device)[:, None]
    xg = x.reshape(g * t, d).index_select(
        0, (group * t + src.clamp(max=t - 1)).reshape(-1))
    ye = _expert_ffn(xg.reshape(g, e, c, d), w1, w3, w2)
    ye = ye * wslot.reshape(g, e, c, 1).to(ye.dtype)
    y = torch.zeros((g * (t + 1), d), dtype=ye.dtype, device=x.device)
    y.index_add_(0, (group * (t + 1) + src).reshape(-1), ye.reshape(-1, d))
    return y.reshape(g, t + 1, d)[:, :t]


def _local_moe(x2d, router, w1, w3, w2, *, e_total: int, k: int,
               cap_factor: float):
    """Route the (T, D) tokens as one group through all ``e_total``
    experts; return the (T, D) output and the aux losses. (The
    reference's ``e_start`` and ``sentinel_t`` serve its expert-parallel
    shards: on one device every expert is local and the sentinel is T.)"""
    t = x2d.shape[0]
    c = capacity(t, e_total, k, cap_factor)
    w, idx, pos, aux = _route(x2d, router, e_total, k)
    y = _dispatch_combine(x2d[None], w[None], idx[None], pos[None], w1, w3,
                          w2, c=c)
    return y[0], aux


def _moe_gspmd_scatter(p, x: torch.Tensor, moe_cfg):
    """One token group per sequence: capacity from S, positions counted
    within each sequence, losses over every token."""
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    c = capacity(x.shape[1], e, k, moe_cfg.capacity_factor)
    w, idx, pos, (lb, z) = _route(x, p["router"], e, k)
    y = _dispatch_combine(x, w, idx, pos, p["w1"], p["w3"], p["w2"], c=c)
    return y, {"load_balance_loss": lb, "router_z_loss": z}


def moe_sublayer(p, x: torch.Tensor, moe_cfg, impl: str | None = None):
    """x: (B, S, D) -> (y, aux), aux holding ``load_balance_loss`` and
    ``router_z_loss`` (0-d fp32 tensors). ``impl`` None means ``"local"``:
    the port has no mesh context."""
    if impl is None:
        impl = "local"
    if impl == "ep_shard_map":
        raise NotImplementedError(
            "impl=\"ep_shard_map\" shards the experts over a mesh's model "
            "axis; the mesh modules are not ported yet (ROADMAP Queue A "
            "3.5). Use \"local\" or \"gspmd_scatter\" on one device")
    if impl == "gspmd_scatter":
        return _moe_gspmd_scatter(p, x, moe_cfg)
    if impl != "local":
        raise ValueError(f"impl must be one of {IMPLS} (or "
                         f"\"ep_shard_map\" under a mesh), got {impl!r}")
    b, s, d = x.shape
    y2, (lb, z) = _local_moe(x.reshape(b * s, d), p["router"], p["w1"],
                             p["w3"], p["w2"], e_total=moe_cfg.n_experts,
                             k=moe_cfg.top_k,
                             cap_factor=moe_cfg.capacity_factor)
    return y2.reshape(b, s, d), {"load_balance_loss": lb,
                                 "router_z_loss": z}

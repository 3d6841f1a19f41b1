"""Capacity-based top-k MoE FFN: the port of ``repro/models/moe.py``.

Three execution paths share the routing math: softmax over the experts,
top-k, weights renormalised over the k picks, a token's position in each
expert's queue by an exclusive cumsum, drops past the capacity
C = ceil(T * k / E * capacity_factor), and the Switch load-balance and
router z losses.

- ``impl="ep_shard_map"`` (the default under a ``ShardCtx``,
  ``models/sharding.py``, as in the reference): expert parallelism over
  the context mesh's model axis. Tokens are sharded over the data axes
  and replicated over the model axis; model position r routes its data
  shard's tokens (the router is replicated, so every position routes
  alike) and runs only its E / tp experts, [r * E / tp, (r + 1) * E / tp),
  as views of the weights where its device holds them; the partial
  outputs of a data row's model positions are summed, the reference's
  ``psum``. Capacity is per data shard (``capacity(T_local, ...)``), so
  with drops EP and ``"local"`` differ in the reference too. The
  reference's ``shard_map`` returns its replicated loss outputs from its
  first device, so the losses are the first data shard's routing
  statistics, here as there. Without a context it is ``"local"``.
- ``impl="local"`` (the default without a context): the whole batch is
  one token group (T = B * S tokens, one capacity), all experts local.
  (The reference runs EP under a context for any impl but
  ``"gspmd_scatter"``; the port runs the impl it is given.)
- ``impl="gspmd_scatter"``: one group per sequence (capacity from S),
  the reference's pure-GSPMD formulation, which also runs on one device
  there. It is kept as a twin of the reference's API; the model's layers
  take the default.

The reference's ``shard_map`` is one program per mesh position; here one
controller loops over the positions, each running on its own device (a
device may repeat). A batch that the data axes do not divide is
replicated over them in the reference, and every data row computes the
same result; the port computes it once, on the first data row.

JAX's ``mode="drop"`` scatters drop out-of-range indices silently;
``index_put_``/``index_add_`` raise on them. So a dropped (expert,
position) pair, or one routed to another position's expert, is sent to
one extra dump slot past the E * C real ones, and a slot no token fills
points at an extra sentinel row past the T real tokens; both extras are
sliced off. Shapes depend only on the capacity, a Python int: the layer
makes no host sync (no ``nonzero``, no boolean-mask indexing, no
``.item()``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import normal_init
from .sharding import current_ctx

IMPLS = ("local", "gspmd_scatter", "ep_shard_map")


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


def _dispatch_combine(x, w, idx, pos, w1, w3, w2, *, c: int,
                      e_start: int = 0):
    """Gather each group's routed tokens into (G, E, C, D) slots, run the
    experts, scatter-add the weighted outputs back.

    x: (G, T, D); w, idx, pos: (G, T, K). w1/w3/w2 hold E experts
    starting at ``e_start``. Pairs past the capacity, or routed to an
    expert outside them, go to the dump slot E * C; empty slots hold the
    sentinel token T, which gathers row T - 1 (weight 0, as the reference
    clips it) and adds into an extra row T, sliced off. Returns
    (G, T, D)."""
    g, t, d = x.shape
    e = w1.shape[0]
    n_slots = e * c
    keep = (pos < c) & (idx >= e_start) & (idx < e_start + e)
    slot = torch.where(keep, (idx - e_start) * c + pos, n_slots)
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
               cap_factor: float, e_start: int = 0,
               sentinel_t: int | None = None):
    """Route the (T, D) tokens as one group over all ``e_total`` experts,
    run the LOCAL ones (w1/w3/w2 hold them, starting at ``e_start``), and
    return the partial (T, D) output covering them and the aux losses.
    Empty slots point at the sentinel row T, sliced off, so
    ``sentinel_t`` (the reference's) must be T."""
    t = x2d.shape[0]
    if sentinel_t is not None and sentinel_t != t:
        raise ValueError(f"sentinel_t={sentinel_t}: empty slots point at "
                         f"the row past the {t} tokens")
    c = capacity(t, e_total, k, cap_factor)
    w, idx, pos, aux = _route(x2d, router, e_total, k)
    y = _dispatch_combine(x2d[None], w[None], idx[None], pos[None], w1, w3,
                          w2, c=c, e_start=e_start)
    return y[0], aux


def _moe_gspmd_scatter(p, x: torch.Tensor, moe_cfg):
    """One token group per sequence: capacity from S, positions counted
    within each sequence, losses over every token."""
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    c = capacity(x.shape[1], e, k, moe_cfg.capacity_factor)
    w, idx, pos, (lb, z) = _route(x, p["router"], e, k)
    y = _dispatch_combine(x, w, idx, pos, p["w1"], p["w3"], p["w2"], c=c)
    return y, {"load_balance_loss": lb, "router_z_loss": z}


def _moe_ep(p, x: torch.Tensor, moe_cfg, ctx):
    """Expert parallelism over ``ctx.mesh``: model position r of data row
    d runs ``_local_moe`` on row d's tokens with experts
    [r * E / tp, (r + 1) * E / tp) on its device; a row's partials are
    summed on ``x``'s device (the reference's ``psum``).

    A position's expert slice is a view of ``p``'s weights when the
    position is on their device. On any other device it is copied there
    on every call (with the router and the row's tokens): the port has
    no resident sharded placement yet, so on a mesh of several cards each
    forward would move the experts again."""
    mesh = ctx.mesh
    b, s, d = x.shape
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    tp = mesh.shape[ctx.model_axis]
    if e % tp:
        raise ValueError(f"n_experts={e} not divisible by tp={tp}")
    axes = tuple(ctx.data_axes) + (ctx.model_axis,)
    if sorted(axes) != sorted(mesh.axis_names):
        raise ValueError(f"a mesh of axes {mesh.axis_names} for data axes "
                         f"{ctx.data_axes} and model axis {ctx.model_axis}")
    grid = mesh.devices.transpose([mesh.axis_names.index(a) for a in axes])
    grid = grid.reshape(-1, tp)
    dp = grid.shape[0]
    # e.g. long_500k B=1: batch can't shard; replicated over data, every
    # data row computes the same result, so the first row alone runs
    rows = dp if b % dp == 0 else 1
    bl, el = b // rows, e // tp
    ys, aux0 = [], None
    for row in range(rows):
        xd = x[row * bl:(row + 1) * bl].reshape(bl * s, d)
        acc = None
        for r in range(tp):
            dev = grid[row, r]
            sl = slice(r * el, (r + 1) * el)
            y2, aux = _local_moe(
                xd.to(dev), p["router"].to(dev), p["w1"][sl].to(dev),
                p["w3"][sl].to(dev), p["w2"][sl].to(dev), e_total=e, k=k,
                cap_factor=moe_cfg.capacity_factor, e_start=r * el,
                sentinel_t=bl * s)
            y2 = y2.to(x.device)
            acc = y2 if acc is None else acc + y2
            if aux0 is None:
                aux0 = tuple(a.to(x.device) for a in aux)
        ys.append(acc.reshape(bl, s, d))
    return torch.cat(ys), {"load_balance_loss": aux0[0],
                           "router_z_loss": aux0[1]}


def moe_sublayer(p, x: torch.Tensor, moe_cfg, impl: str | None = None):
    """x: (B, S, D) -> (y, aux), aux holding ``load_balance_loss`` and
    ``router_z_loss`` (0-d fp32 tensors). Under a ``ShardCtx``
    (``models/sharding.py``) every impl but ``"gspmd_scatter"`` runs
    expert parallelism, as in the reference; ``impl`` None means
    ``"ep_shard_map"`` there, else ``"local"``."""
    ctx = current_ctx()
    if impl is None:
        impl = "ep_shard_map" if ctx is not None else "local"
    if impl == "gspmd_scatter":
        return _moe_gspmd_scatter(p, x, moe_cfg)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if ctx is not None:   # as in the reference, "local" too runs EP here
        return _moe_ep(p, x, moe_cfg, ctx)
    # no context (single device): all experts local
    b, s, d = x.shape
    y2, (lb, z) = _local_moe(x.reshape(b * s, d), p["router"], p["w1"],
                             p["w3"], p["w2"], e_total=moe_cfg.n_experts,
                             k=moe_cfg.top_k,
                             cap_factor=moe_cfg.capacity_factor)
    return y2.reshape(b, s, d), {"load_balance_loss": lb,
                                 "router_z_loss": z}

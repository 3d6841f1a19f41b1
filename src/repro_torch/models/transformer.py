"""Decoder-only LM stack: the serving subset of ``repro/models/
transformer.py`` (init, prefill, decode) on one device.

The reference stacks each period's parameters on a leading axis and
scans over them; the port keeps one :class:`DecoderLayer` per layer in an
``nn.ModuleList`` and one cache per layer
(:class:`~repro_torch.models.layers.KVCache` for an attention layer,
:class:`~repro_torch.models.mamba.SSMCache` for an SSM layer), in layer
order (layer ``p * period + i`` is the reference's
``periods["sub_<i>"][p]``). Each layer is an attention or SSM (Mamba-2)
mixer, with a dense SwiGLU FFN, an MoE FFN (``models/moe.py``) or none.

The training losses (``chunked_cross_entropy``, ``decoder_lm_loss``)
run the chunked attention and SSD twins, as the reference trains through
XLA and not its Pallas kernels; under autograd each layer, each KV chunk,
each SSD chunk and each cross-entropy chunk is checkpointed, as the
reference's ``jax.checkpoint``s (the reference nests per-period and
per-sublayer checkpoints; here a layer is a sublayer, so one per layer).

Parameter sharding is rule-based, as the reference's
(``param_spec_tree``: Megatron TP on the model axis + ZeRO/FSDP on the
data axis, MoE experts EP-sharded), keyed by ``named_parameters()``;
``launch/specs.py`` resolves the specs on a mesh and the dry run counts
their bytes. ``shard_caches``, like ``sharding.shard``, changes no value:
eager PyTorch has no partitioner. ``_carry_barrier`` is an XLA
scheduling pin with no eager counterpart.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelCfg

from . import layers, mamba, moe
from .layers import KVCache, maybe_checkpoint
from .mamba import SSMCache

AUX_LOSSES = ("load_balance_loss", "router_z_loss")


class DecoderLayer(nn.Module):
    """One layer: RMSNorm -> mixer -> residual, then (when the layer has
    one) RMSNorm -> FFN -> residual. The mixer is ``attn`` or ``ssm``, the
    FFN a dense ``ffn`` or an MoE ``moe``; each is an ``nn.ParameterDict``
    with the reference's names, and a layer holds only the ones it has (as
    the reference's parameter tree does)."""

    def __init__(self, norm1: torch.Tensor,
                 attn: nn.ParameterDict | None = None,
                 norm2: torch.Tensor | None = None,
                 ffn: nn.ParameterDict | None = None, *,
                 ssm: nn.ParameterDict | None = None,
                 moe: nn.ParameterDict | None = None):
        super().__init__()
        if (attn is None) == (ssm is None):
            raise ValueError("a layer has exactly one mixer, attn or ssm")
        if ffn is not None and moe is not None:
            raise ValueError("a layer has at most one FFN, ffn or moe")
        if (norm2 is None) != (ffn is None and moe is None):
            raise ValueError("norm2 comes with an FFN, ffn or moe")
        self.norm1 = nn.Parameter(norm1)
        self.attn = attn
        self.ssm = ssm
        self.norm2 = None if norm2 is None else nn.Parameter(norm2)
        self.ffn = ffn
        self.moe = moe


class DecoderParams(nn.Module):
    """All parameters of a decoder-only LM, in the reference's (in, out)
    layouts: ``embed`` (vocab_padded, d), ``final_norm`` (d), ``lm_head``
    (d, vocab_padded) unless embeddings are tied, and ``layers``."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers_: list[DecoderLayer],
                 lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.layers = nn.ModuleList(layers_)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def init_decoder_params(cfg: ModelCfg, generator: torch.Generator,
                        dtype=torch.bfloat16) -> DecoderParams:
    """Random parameters on ``generator``'s device, distributed as the
    reference's (its values differ: the generators differ)."""
    vp, d = cfg.vocab_padded, cfg.d_model
    dev = generator.device

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    embed = layers.normal_init(generator, (vp, d), 0.02, dtype)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = layers.normal_init(generator, (d, vp),
                                     1.0 / math.sqrt(d), dtype)
    stack = []
    for l in range(cfg.n_layers):
        mixer, ffn_kind = cfg.layer_kind(l)
        if mixer == "attn":
            mix = dict(attn=layers.init_attention(generator, cfg,
                                                  dtype=dtype))
        else:
            mix = dict(ssm=mamba.init_mamba(generator, d, cfg.ssm, dtype))
        if ffn_kind == "dense":
            mix.update(norm2=ones(),
                       ffn=layers.init_ffn(generator, d, cfg.d_ff, dtype))
        elif ffn_kind == "moe":
            mix.update(norm2=ones(),
                       moe=moe.init_moe(generator, d, cfg.moe, dtype))
        stack.append(DecoderLayer(ones(), **mix))
    return DecoderParams(embed, ones(), stack, lm_head)


# --------------------------------------------------------------------------
# Sharding rules (symbolic; resolved by repro_torch.models.sharding)
# --------------------------------------------------------------------------

_COL = ("data", "model")     # column-parallel: (in=FSDP, out=TP)
_ROW = ("model", "data")     # row-parallel:    (in=TP, out=FSDP)

_RULES_2D = {
    "wq": _COL, "wk": _COL, "wv": _COL, "w1": _COL, "w3": _COL,
    "wz": _COL, "wx": _COL, "wB": _COL, "wC": _COL, "wdt": _COL,
    "wo": _ROW, "w2": _ROW,
    # embed: vocab REPLICATED, d_model TP-sharded — the token gather and its
    # backward scatter-add stay local (a vocab-sharded table makes GSPMD
    # replicate the (V, D) fp32 gradient: 4 x 2 GiB/device at jamba scale).
    "embed": (None, "model"), "lm_head": ("data", "model"),
    "router": ("data", None), "conv_w": (None, "model"),
}
_RULES_1D = {
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "conv_b": ("model",), "norm": ("model",),
    "dt_bias": ("model",), "A_log": ("model",), "D": ("model",),
    "final_norm": (None,), "norm1": (None,), "norm2": (None,),
    "norm_x": (None,), "enc_norm": (None,),
}
_RULES_3D_MOE = {  # (E, D, F) / (E, F, D)
    "w1": ("model", "data", None), "w3": ("model", "data", None),
    "w2": ("model", None, "data"),
}


def param_spec_tree(params: nn.Module) -> dict[str, tuple]:
    """Symbolic partition-spec tuples, ``{name: spec}`` keyed by
    ``params.named_parameters()`` (a decoder's or an encoder-decoder's).
    Each is the reference's rule for that leaf without the leading
    ``None`` of its stacked period axis: the port keeps one module per
    layer."""

    def rule(name: str, leaf: torch.Tensor) -> tuple:
        names = name.split(".")
        leaf_name, nd = names[-1], leaf.ndim
        if "moe" in names and nd == 3 and leaf_name in _RULES_3D_MOE:
            return _RULES_3D_MOE[leaf_name]
        if nd == 2 and leaf_name in _RULES_2D:
            return _RULES_2D[leaf_name]
        if nd == 1 and leaf_name in _RULES_1D:
            return _RULES_1D[leaf_name]
        if nd <= 1:
            return (None,) * nd
        raise ValueError(f"no sharding rule for {name} ndim={nd}")

    return {name: rule(name, p) for name, p in params.named_parameters()}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _sublayer_apply(layer: DecoderLayer, x, cfg: ModelCfg, positions,
                    cache, cache_pos: int | None, attn_impl: str,
                    ssd_impl: str):
    """One layer: mixer + optional FFN. Returns (x, new_cache, aux): aux
    holds an MoE layer's losses, and is empty for any other layer."""
    aux = {}
    h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
    if layer.attn is not None:
        y, new_cache = layers.attention_sublayer(
            layer.attn, h, cfg, positions, causal=True,
            cache=cache if isinstance(cache, KVCache) else None,
            cache_pos=cache_pos, attn_impl=attn_impl)
    else:
        y, new_cache = mamba.mamba_sublayer(
            layer.ssm, h, cfg.ssm,
            cache=cache if isinstance(cache, SSMCache) else None,
            cache_pos=cache_pos, ssd_impl=ssd_impl)
    x = x + y
    if layer.norm2 is not None:
        h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
        if layer.moe is not None:
            y, aux = moe.moe_sublayer(layer.moe, h, cfg.moe)
        else:
            y = layers.ffn_sublayer(layer.ffn, h)
        x = x + y
    return x, new_cache, aux


def decoder_stack(params: DecoderParams, x, cfg: ModelCfg, positions,
                  caches: list | None = None, cache_pos: int | None = None,
                  attn_impl: str = "flash", ssd_impl: str = "kernel",
                  remat: bool = True):
    """Run all layers. Returns (x, new_caches, aux_losses).

    Without caches this is the no-cache forward; with them, the serving
    path (prefill when x has more than one token, else a decode step at
    ``cache_pos``), which fills the caches in place. ``aux_losses`` sums
    each of ``AUX_LOSSES`` over the MoE layers (0-d fp32 tensors, zeros
    without MoE layers), as the reference's. With ``remat`` (the
    reference's default), the no-cache forward checkpoints each layer
    under autograd: the backward keeps only the layers' inputs and
    recomputes one layer at a time.
    """
    if caches is not None and len(caches) != len(params.layers):
        raise ValueError(f"{len(caches)} caches for "
                         f"{len(params.layers)} layers")
    new_caches = None if caches is None else []
    aux_losses = {name: torch.zeros((), dtype=torch.float32,
                                    device=x.device) for name in AUX_LOSSES}
    for l, layer in enumerate(params.layers):
        if caches is None and remat:
            x, nc, aux = maybe_checkpoint(_sublayer_apply, layer, x, cfg,
                                          positions, None, cache_pos,
                                          attn_impl, ssd_impl)
        else:
            x, nc, aux = _sublayer_apply(
                layer, x, cfg, positions,
                None if caches is None else caches[l], cache_pos,
                attn_impl, ssd_impl)
        if new_caches is not None:
            new_caches.append(nc)
        for name, value in aux.items():
            aux_losses[name] = aux_losses[name] + value
    return x, new_caches, aux_losses


def embed_tokens(params: DecoderParams, tokens, cfg: ModelCfg):
    return params.embed[tokens]


def unembed(params: DecoderParams, x, cfg: ModelCfg):
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ w


# --------------------------------------------------------------------------
# Losses / serving entry points
# --------------------------------------------------------------------------

def _ce_chunk(xc, lc, w):
    """Summed CE and count of one chunk's valid (label >= 0) tokens."""
    valid = (lc >= 0).float()
    logits = (xc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_cross_entropy(params, x, labels, cfg: ModelCfg,
                          chunk: int = 1024) -> torch.Tensor:
    """Final-norm + LM head + CE over sequence chunks, each checkpointed
    under autograd, so the (B, S, V) logits are never whole. Labels of -1
    (and the padding of a last short chunk) count for nothing; the mean
    is over the valid tokens."""
    b, s, d = x.shape
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s + pad, chunk):
        t, c = maybe_checkpoint(_ce_chunk, x[:, start:start + chunk],
                                labels[:, start:start + chunk], w)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def decoder_lm_loss(params: DecoderParams, batch: dict, cfg: ModelCfg,
                    lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Next-token CE (+ MoE aux). batch: ``tokens`` (or ``embeds``),
    ``labels``, ``positions``? Returns ``(loss, {"ce", *AUX_LOSSES})``.
    Runs the chunked attention and SSD twins (the CUDA kernels have no
    backward)."""
    device = params.embed.device
    if "embeds" in batch:
        x = batch["embeds"].to(device)
    else:
        x = embed_tokens(params, batch["tokens"].to(device), cfg)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, device)
    x, _, aux = decoder_stack(params, x, cfg, positions, attn_impl="chunked",
                              ssd_impl="chunked")
    ce = chunked_cross_entropy(params, x, batch["labels"].to(device), cfg)
    loss = (ce + lb_coef * aux["load_balance_loss"]
            + z_coef * aux["router_z_loss"])
    return loss, {"ce": ce, **aux}


def init_decoder_caches(cfg: ModelCfg, batch: int, s_max: int,
                        dtype=torch.bfloat16, device=None) -> list:
    """One zeroed cache per layer: a (B, s_max, Hkv, Dh) K/V cache for an
    attention layer; for an SSM layer a conv window in ``dtype`` and a
    state in fp32 (whatever ``dtype``), as the reference's."""
    shape = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    caches = []
    for l in range(cfg.n_layers):
        if cfg.layer_kind(l)[0] == "attn":
            caches.append(KVCache(
                torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device)))
        else:
            caches.append(mamba.init_ssm_cache(cfg, batch, dtype, device))
    return caches


def _positions(batch: dict, b: int, s: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)
    return positions.to(device)


@torch.no_grad()
def decoder_prefill(params: DecoderParams, batch: dict, cfg: ModelCfg,
                    s_max: int, attn_impl: str = "flash",
                    ssd_impl: str = "kernel"):
    """Run the prompt, fill caches, return last-token logits + caches."""
    device = params.embed.device
    if "embeds" in batch:
        x = batch["embeds"].to(device)
    else:
        x = embed_tokens(params, batch["tokens"].to(device), cfg)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, device)
    caches = init_decoder_caches(cfg, b, s_max, x.dtype, device)
    caches = shard_caches(caches)
    x, new_caches, _ = decoder_stack(params, x, cfg, positions, caches,
                                     attn_impl=attn_impl, ssd_impl=ssd_impl)
    logits = unembed(params, x[:, -1:, :], cfg)
    return logits, new_caches


@torch.no_grad()
def decoder_decode_step(params: DecoderParams, tokens, caches, pos: int,
                        cfg: ModelCfg):
    """One token step. tokens: (B, 1); pos: the current length (an int).
    The caches are updated in place and returned."""
    x = embed_tokens(params, tokens.to(params.embed.device), cfg)
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                           device=x.device)
    x, new_caches, _ = decoder_stack(params, x, cfg, positions, caches,
                                     cache_pos=int(pos))
    logits = unembed(params, x, cfg)
    return logits, new_caches


def cache_axes(leaf_ndim: int) -> tuple | None:
    """Symbolic layout per cache leaf, by the rank of the reference's
    *stacked* leaf (a leading period axis): pass a port cache leaf's
    ``ndim + 1`` and drop the leading ``None``.

    Defaults (overridable via ShardCtx symbols): cache batch on "cache_b"
    (data axes when the batch divides, else replicated — long_500k B=1),
    KV sequence on "cache_s" (model axis: flash-decoding style, valid for
    any head count; all data+model axes when the batch can't shard)."""
    if leaf_ndim == 5:   # stacked KV: (P, B, S, H, D)
        return (None, "cache_b", "cache_s", None, None)
    if leaf_ndim == 6:   # stacked SSM state: (P, B, G, R, N, Ph)
        return (None, "cache_b", None, "model", None, None)
    if leaf_ndim == 4:   # stacked conv state: (P, B, K, C)
        return (None, "cache_b", None, "model")
    return None


def shard_caches(caches):
    """The reference's sharding constraint on every cache leaf (its spec
    ``cache_axes(leaf.ndim + 1)[1:]``). Like ``sharding.shard`` it is the
    identity: it returns ``caches``."""
    return caches

"""Encoder-decoder stack (the SeamlessM4T backbone): a bidirectional
encoder and a causal decoder with cross-attention, the serving part of
``repro/models/encdec.py`` on one device.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model). The reference stacks
each stack's layers on a leading axis and scans over them; the port keeps
one module per layer (an :class:`~repro_torch.models.transformer.
DecoderLayer` with ``attn`` and ``ffn`` per encoder layer, a
:class:`CrossDecoderLayer` per decoder layer) and one cache per decoder
layer, ``{"self": KVCache, "cross": CrossCache}``. The cross-attention
K/V are computed from the encoder's output once, at prefill, and cached:
a decode step reads them from the cache.

``encdec_lm_loss`` trains through the chunked attention twin (the CUDA
kernel has no backward); with ``remat`` (the reference's default),
``encoder_forward`` and ``decoder_forward`` checkpoint each layer under
autograd, as the reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg

from . import layers
from .layers import KVCache, maybe_checkpoint
from .transformer import (DecoderLayer, chunked_cross_entropy, shard_caches,
                          unembed)


class CrossCache(NamedTuple):
    k: torch.Tensor  # (B, S_enc, H_kv, D)
    v: torch.Tensor


class CrossDecoderLayer(nn.Module):
    """One decoder layer: causal self-attention, cross-attention over the
    encoder's output, dense FFN, each behind an RMSNorm and a residual.
    Parameter names are the reference's."""

    def __init__(self, norm1: torch.Tensor, attn: nn.ParameterDict,
                 norm_x: torch.Tensor, xattn: nn.ParameterDict,
                 norm2: torch.Tensor, ffn: nn.ParameterDict):
        super().__init__()
        self.norm1 = nn.Parameter(norm1)
        self.attn = attn
        self.norm_x = nn.Parameter(norm_x)
        self.xattn = xattn
        self.norm2 = nn.Parameter(norm2)
        self.ffn = ffn


class EncDecParams(nn.Module):
    """All parameters of an encoder-decoder LM, in the reference's (in,
    out) layouts: ``embed`` (vocab_padded, d), ``final_norm`` and
    ``lm_head`` (d, vocab_padded), the encoder's ``enc_layers`` and
    ``enc_norm`` (the reference's ``enc.periods.sub_0`` and
    ``enc.enc_norm``) and the decoder's ``dec_layers``
    (``dec.periods.sub_0``)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 lm_head: torch.Tensor, enc_layers: list[DecoderLayer],
                 enc_norm: torch.Tensor, dec_layers: list[CrossDecoderLayer]):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = nn.Parameter(lm_head)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_norm = nn.Parameter(enc_norm)
        self.dec_layers = nn.ModuleList(dec_layers)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def init_encdec_params(cfg: ModelCfg, generator: torch.Generator,
                       dtype=torch.bfloat16) -> EncDecParams:
    """Random parameters on ``generator``'s device, distributed as the
    reference's (its values differ: the generators differ)."""
    vp, d = cfg.vocab_padded, cfg.d_model
    dev = generator.device

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    def attn():
        return layers.init_attention(generator, cfg, dtype=dtype)

    def ffn():
        return layers.init_ffn(generator, d, cfg.d_ff, dtype)

    embed = layers.normal_init(generator, (vp, d), 0.02, dtype)
    lm_head = layers.normal_init(generator, (d, vp), 1.0 / math.sqrt(d),
                                 dtype)
    enc = [DecoderLayer(ones(), attn(), ones(), ffn())
           for _ in range(cfg.n_enc_layers)]
    dec = [CrossDecoderLayer(ones(), attn(), ones(), attn(), ones(), ffn())
           for _ in range(cfg.n_layers)]
    return EncDecParams(embed, ones(), lm_head, enc, ones(), dec)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _enc_layer(layer: DecoderLayer, x, cfg: ModelCfg, positions,
               attn_impl: str):
    h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
    y, _ = layers.attention_sublayer(layer.attn, h, cfg, positions,
                                     causal=False, attn_impl=attn_impl)
    x = x + y
    h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
    return x + layers.ffn_sublayer(layer.ffn, h)


def encoder_forward(params: EncDecParams, enc_embeds: torch.Tensor,
                    cfg: ModelCfg, attn_impl: str = "flash",
                    remat: bool = True) -> torch.Tensor:
    """Non-causal self-attention with RoPE at positions 0..S_enc-1 and a
    dense FFN per layer (each layer checkpointed under autograd with
    ``remat``), then the encoder's RMSNorm."""
    x = enc_embeds
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for layer in params.enc_layers:
        if remat:
            x = maybe_checkpoint(_enc_layer, layer, x, cfg, positions,
                                 attn_impl)
        else:
            x = _enc_layer(layer, x, cfg, positions, attn_impl)
    return layers.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _cross_kv(pp, memory: torch.Tensor, cfg: ModelCfg):
    b, se, _ = memory.shape
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    k = (memory @ pp["wk"]).reshape(b, se, hkv, dh)
    v = (memory @ pp["wv"]).reshape(b, se, hkv, dh)
    if "bk" in pp:
        k = k + pp["bk"].reshape(hkv, dh)
        v = v + pp["bv"].reshape(hkv, dh)
    return k, v


def _dec_layer(layer: CrossDecoderLayer, x, memory, cfg: ModelCfg,
               positions, pc, cache_pos, attn_impl: str):
    h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
    y, _ = layers.attention_sublayer(
        layer.attn, h, cfg, positions, causal=True,
        cache=None if pc is None else pc["self"], cache_pos=cache_pos,
        attn_impl=attn_impl)
    x = x + y
    h = layers.rms_norm(x, layer.norm_x, cfg.norm_eps)
    if memory is not None:
        ck, cv = _cross_kv(layer.xattn, memory, cfg)
        if pc is not None:
            pc["cross"].k.copy_(ck)
            pc["cross"].v.copy_(cv)
    else:
        ck, cv = pc["cross"]
    y, _ = layers.attention_sublayer(layer.xattn, h, cfg, positions,
                                     causal=False, kv_override=(ck, cv),
                                     attn_impl=attn_impl)
    x = x + y
    h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
    return x + layers.ffn_sublayer(layer.ffn, h)


def decoder_forward(params: EncDecParams, tokens: torch.Tensor,
                    memory: torch.Tensor | None, cfg: ModelCfg, *,
                    caches: list | None = None, cache_pos: int | None = None,
                    attn_impl: str = "flash", remat: bool = True):
    """Returns (x, new_caches). ``memory`` is the encoder's output, or
    None in a decode step, which reads the cross K/V from ``caches``.
    With caches, a prefill writes the self-attention prefix and the cross
    K/V into them in place; a decode step (one token at ``cache_pos``)
    inserts its self K/V. Without caches and with ``remat``, each layer
    is checkpointed under autograd."""
    x = params.embed[tokens]
    b, s, _ = x.shape
    if cache_pos is not None and s == 1:
        positions = torch.full((b, 1), int(cache_pos), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if caches is not None and len(caches) != len(params.dec_layers):
        raise ValueError(f"{len(caches)} caches for "
                         f"{len(params.dec_layers)} decoder layers")
    for l, layer in enumerate(params.dec_layers):
        args = (layer, x, memory, cfg, positions,
                None if caches is None else caches[l], cache_pos, attn_impl)
        if caches is None and remat:
            x = maybe_checkpoint(_dec_layer, *args)
        else:
            x = _dec_layer(*args)
    return x, caches


# --------------------------------------------------------------------------
# Loss / serving entry points
# --------------------------------------------------------------------------

def encdec_lm_loss(params: EncDecParams, batch: dict, cfg: ModelCfg):
    """Decoder CE over ``labels`` given ``enc_embeds`` and ``tokens``,
    through the chunked attention twin. Returns ``(ce, {"ce": ce})``."""
    device = params.embed.device
    memory = encoder_forward(params, batch["enc_embeds"].to(device), cfg,
                             attn_impl="chunked")
    x, _ = decoder_forward(params, batch["tokens"].to(device), memory, cfg,
                           attn_impl="chunked")
    ce = chunked_cross_entropy(params, x, batch["labels"].to(device), cfg)
    return ce, {"ce": ce}


def init_encdec_caches(cfg: ModelCfg, batch: int, s_max: int, s_enc: int,
                       dtype=torch.bfloat16, device=None) -> list:
    """One zeroed ``{"self": KVCache, "cross": CrossCache}`` per decoder
    layer: self K/V (B, s_max, Hkv, Dh), cross K/V (B, s_enc, Hkv, Dh)."""

    def zeros(s):
        return torch.zeros((batch, s, cfg.n_kv_heads, cfg.d_head),
                           dtype=dtype, device=device)

    return [{"self": KVCache(zeros(s_max), zeros(s_max)),
             "cross": CrossCache(zeros(s_enc), zeros(s_enc))}
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def encdec_prefill(params: EncDecParams, batch: dict, cfg: ModelCfg,
                   s_max: int, attn_impl: str = "flash"):
    """Encode ``enc_embeds``, run the decoder over ``tokens`` filling the
    caches, return the last token's logits and the caches."""
    device = params.embed.device
    enc_embeds = batch["enc_embeds"].to(device)
    memory = encoder_forward(params, enc_embeds, cfg, attn_impl=attn_impl)
    tokens = batch["tokens"].to(device)
    caches = init_encdec_caches(cfg, tokens.shape[0], s_max,
                                enc_embeds.shape[1], enc_embeds.dtype,
                                device)
    caches = shard_caches(caches)
    x, caches = decoder_forward(params, tokens, memory, cfg, caches=caches,
                                attn_impl=attn_impl)
    return unembed(params, x[:, -1:, :], cfg), caches


@torch.no_grad()
def encdec_decode_step(params: EncDecParams, tokens, caches, pos: int,
                       cfg: ModelCfg):
    """One token step. tokens: (B, 1); pos: the current length (an int).
    The self caches are updated in place and returned with the cross
    caches, which a step only reads."""
    x, caches = decoder_forward(params, tokens.to(params.embed.device), None,
                                cfg, caches=caches, cache_pos=int(pos))
    return unembed(params, x, cfg), caches

"""Decoder-only LM stack: the serving subset of ``repro/models/
transformer.py`` (init, prefill, decode) on one device.

The reference stacks each period's parameters on a leading axis and
scans over them; the port keeps one :class:`DecoderLayer` per layer in an
``nn.ModuleList`` and one :class:`~repro_torch.models.layers.KVCache` per
layer, in layer order (layer ``p * period + i`` is the reference's
``periods["sub_<i>"][p]``). Each layer is an attention mixer and a dense
SwiGLU FFN; an SSM mixer or an MoE FFN raises ``NotImplementedError``.

Not ported yet (ROADMAP Queue A 10): ``param_spec_tree``,
``shard_caches`` and ``cache_axes`` (TPU-mesh sharding), the training
losses ``chunked_cross_entropy`` and ``decoder_lm_loss``, and
``_carry_barrier`` (an XLA scheduling pin with no eager counterpart).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg

from . import layers
from .layers import KVCache

_LATER = ("is not ported yet: the port serves dense attention decoders; "
          "MoE, Mamba and enc-dec models come later (ROADMAP Queue A 10)")


def check_supported(cfg: ModelCfg) -> None:
    """Raise NotImplementedError for a config with a layer the port does
    not run yet (SSM mixer, MoE FFN) or an encoder."""
    if cfg.is_enc_dec:
        raise NotImplementedError(f"{cfg.name}: an encoder-decoder {_LATER}")
    for l in range(cfg.n_layers):
        mixer, ffn = cfg.layer_kind(l)
        if mixer != "attn" or ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: layer {l} ({mixer} mixer, {ffn} FFN) {_LATER}")


class DecoderLayer(nn.Module):
    """One layer: RMSNorm -> attention -> residual, RMSNorm -> dense FFN
    -> residual. ``attn`` and ``ffn`` are ``nn.ParameterDict``s with the
    reference's names."""

    def __init__(self, norm1: torch.Tensor, attn: nn.ParameterDict,
                 norm2: torch.Tensor, ffn: nn.ParameterDict):
        super().__init__()
        self.norm1 = nn.Parameter(norm1)
        self.attn = attn
        self.norm2 = nn.Parameter(norm2)
        self.ffn = ffn


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
    check_supported(cfg)
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
    for _ in range(cfg.n_layers):
        attn = layers.init_attention(generator, cfg, dtype=dtype)
        ffn = layers.init_ffn(generator, d, cfg.d_ff, dtype)
        stack.append(DecoderLayer(ones(), attn, ones(), ffn))
    return DecoderParams(embed, ones(), stack, lm_head)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _sublayer_apply(layer: DecoderLayer, x, cfg: ModelCfg, positions,
                    cache: KVCache | None, cache_pos: int | None,
                    attn_impl: str):
    """One layer: attention mixer + dense FFN. Returns (x, new_cache)."""
    h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
    y, new_cache = layers.attention_sublayer(
        layer.attn, h, cfg, positions, causal=True, cache=cache,
        cache_pos=cache_pos, attn_impl=attn_impl)
    x = x + y
    h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
    return x + layers.ffn_sublayer(layer.ffn, h), new_cache


def decoder_stack(params: DecoderParams, x, cfg: ModelCfg, positions,
                  caches: list[KVCache] | None = None,
                  cache_pos: int | None = None, attn_impl: str = "flash"):
    """Run all layers. Returns (x, new_caches).

    Without caches this is the no-cache forward; with them, the serving
    path (prefill when x has more than one token, else a decode step at
    ``cache_pos``), which fills the caches in place. (The reference also
    returns MoE aux losses; dense layers have none.)
    """
    if caches is not None and len(caches) != len(params.layers):
        raise ValueError(f"{len(caches)} caches for "
                         f"{len(params.layers)} layers")
    new_caches = None if caches is None else []
    for l, layer in enumerate(params.layers):
        x, nc = _sublayer_apply(layer, x, cfg, positions,
                                None if caches is None else caches[l],
                                cache_pos, attn_impl)
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches


def embed_tokens(params: DecoderParams, tokens, cfg: ModelCfg):
    return params.embed[tokens]


def unembed(params: DecoderParams, x, cfg: ModelCfg):
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ w


# --------------------------------------------------------------------------
# Serving entry points
# --------------------------------------------------------------------------

def init_decoder_caches(cfg: ModelCfg, batch: int, s_max: int,
                        dtype=torch.bfloat16, device=None) -> list[KVCache]:
    """One zeroed (B, s_max, Hkv, Dh) K/V cache per layer."""
    check_supported(cfg)
    shape = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def _positions(batch: dict, b: int, s: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)
    return positions.to(device)


@torch.no_grad()
def decoder_prefill(params: DecoderParams, batch: dict, cfg: ModelCfg,
                    s_max: int, attn_impl: str = "flash"):
    """Run the prompt, fill caches, return last-token logits + caches."""
    device = params.embed.device
    if "embeds" in batch:
        x = batch["embeds"].to(device)
    else:
        x = embed_tokens(params, batch["tokens"].to(device), cfg)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, device)
    caches = init_decoder_caches(cfg, b, s_max, x.dtype, device)
    x, new_caches = decoder_stack(params, x, cfg, positions, caches,
                                  attn_impl=attn_impl)
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
    x, new_caches = decoder_stack(params, x, cfg, positions, caches,
                                  cache_pos=int(pos))
    logits = unembed(params, x, cfg)
    return logits, new_caches

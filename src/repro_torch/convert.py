"""Move params, images and LM caches into the port's tensors.

CNN params keep the reference package's structure: a list aligned with
``net.layers`` of ``{"w": (k, k, Cin, Cout), "b": (Cout,)}`` per conv and
``{}`` per pool — plain dicts, not ``nn.Module``s, because the span
engine slices them by layer index. LM params become the port's
``DecoderParams`` (``EncDecParams`` for an encoder-decoder config): the
reference's stacked periods unstacked into one layer each, every weight
in the same (in, out) layout. Inputs may be
numpy arrays (including bfloat16 ones), anything ``numpy.asarray``
accepts, or tensors.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def array_from_numpy(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """One array as a tensor on ``device`` (same dtype, same values)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # numpy extension type torch cannot read
        return torch.from_numpy(arr.astype(np.float32)).to(
            device, torch.bfloat16)
    # np.array copies: the tensor owns writable memory even when the
    # source is a read-only view (as numpy views of JAX arrays are)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(params, device: str | torch.device = "cpu"
                      ) -> list[dict]:
    """Per-layer param dicts with every array as a tensor on ``device``."""
    return [{name: array_from_numpy(v, device) for name, v in p.items()}
            for p in params]


def _layer_index(cfg):
    """(sub index i, period p) in layer order: layer p * period + i is the
    reference's ``periods["sub_<i>"][p]``."""
    return [(l % cfg.period, l // cfg.period) for l in range(cfg.n_layers)]


def _layer_kwargs(sub, p, device):
    """A stacked layer tree at period index p as keyword arguments of the
    layer's module: dicts as ``nn.ParameterDict``s, vectors as tensors."""

    def t(x):
        return array_from_numpy(np.asarray(x)[p], device)

    return {name: nn.ParameterDict({k: nn.Parameter(t(x))
                                    for k, x in v.items()})
            if isinstance(v, dict) else t(v) for name, v in sub.items()}


def lm_params_from_numpy(params, cfg, device: str | torch.device = "cpu"):
    """The reference's LM parameter tree (arrays as numpy) as the port's
    :class:`~repro_torch.models.transformer.DecoderParams` on ``device``,
    or for an encoder-decoder config its
    :class:`~repro_torch.models.encdec.EncDecParams`: a pure unstacking,
    values and layouts unchanged (an MoE router stays fp32)."""
    from repro_torch.models import encdec, transformer

    def t(x):
        return array_from_numpy(x, device)

    if cfg.is_enc_dec:
        enc = params["enc"]["periods"]["sub_0"]
        dec = params["dec"]["periods"]["sub_0"]
        return encdec.EncDecParams(
            t(params["embed"]), t(params["final_norm"]),
            t(params["lm_head"]),
            [transformer.DecoderLayer(**_layer_kwargs(enc, p, device))
             for p in range(cfg.n_enc_layers)],
            t(params["enc"]["enc_norm"]),
            [encdec.CrossDecoderLayer(**_layer_kwargs(dec, p, device))
             for p in range(cfg.n_layers)])
    layers = [transformer.DecoderLayer(**_layer_kwargs(
        params["periods"][f"sub_{i}"], p, device))
        for i, p in _layer_index(cfg)]
    lm_head = params.get("lm_head")
    return transformer.DecoderParams(
        t(params["embed"]), t(params["final_norm"]), layers,
        None if lm_head is None else t(lm_head))


def lm_caches_from_numpy(caches, cfg, device: str | torch.device = "cpu"):
    """The reference's stacked caches (as numpy) as the port's per-layer
    list. Decoder-only: ``{"sub_<i>": cache}`` with a leading period
    axis; a ``KVCache(k, v)`` becomes a
    :class:`~repro_torch.models.layers.KVCache` and an
    ``SSMCache(conv, state)`` a :class:`~repro_torch.models.mamba.
    SSMCache`, told apart by their field names (both are pairs, so
    unpacking alone would not tell them apart). Encoder-decoder:
    ``{"self": KVCache, "cross": CrossCache}`` with a leading layer axis
    becomes one such dict per decoder layer, with the port's
    :class:`~repro_torch.models.encdec.CrossCache`."""
    from repro_torch.models.encdec import CrossCache
    from repro_torch.models.layers import KVCache
    from repro_torch.models.mamba import SSMCache

    kinds = {KVCache._fields: KVCache, SSMCache._fields: SSMCache}

    def unstack(cache, p, kind):
        return kind(*(array_from_numpy(np.asarray(leaf)[p], device)
                      for leaf in cache))

    if cfg.is_enc_dec:
        return [{"self": unstack(caches["self"], l, KVCache),
                 "cross": unstack(caches["cross"], l, CrossCache)}
                for l in range(cfg.n_layers)]
    out = []
    for i, p in _layer_index(cfg):
        cache = caches[f"sub_{i}"]
        kind = kinds.get(getattr(cache, "_fields", None))
        if kind is None:
            raise TypeError(f"sub_{i}: a cache with fields {list(kinds)} "
                            f"expected, got {type(cache).__name__}")
        out.append(unstack(cache, p, kind))
    return out

"""Move params, images and LM caches into the port's tensors.

CNN params keep the reference package's structure: a list aligned with
``net.layers`` of ``{"w": (k, k, Cin, Cout), "b": (Cout,)}`` per conv and
``{}`` per pool — plain dicts, not ``nn.Module``s, because the span
engine slices them by layer index. LM params become the port's
``DecoderParams``: the reference's stacked periods unstacked into one
layer each, every weight in the same (in, out) layout. Inputs may be
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


def lm_params_from_numpy(params, cfg, device: str | torch.device = "cpu"):
    """The reference's decoder-only LM parameter tree (arrays as numpy)
    as the port's :class:`~repro_torch.models.transformer.DecoderParams`
    on ``device``: a pure unstacking, values and layouts unchanged."""
    from repro_torch.models import transformer

    transformer.check_supported(cfg)

    def t(x):
        return array_from_numpy(x, device)

    def pdict(tree, p):
        return nn.ParameterDict({name: nn.Parameter(t(np.asarray(v)[p]))
                                 for name, v in tree.items()})

    layers = []
    for i, p in _layer_index(cfg):
        sub = params["periods"][f"sub_{i}"]
        layers.append(transformer.DecoderLayer(
            t(np.asarray(sub["norm1"])[p]), pdict(sub["attn"], p),
            t(np.asarray(sub["norm2"])[p]), pdict(sub["ffn"], p)))
    lm_head = params.get("lm_head")
    return transformer.DecoderParams(
        t(params["embed"]), t(params["final_norm"]), layers,
        None if lm_head is None else t(lm_head))


def lm_caches_from_numpy(caches, cfg, device: str | torch.device = "cpu"):
    """The reference's stacked KV caches (``{"sub_<i>": KVCache(k, v)}``
    with (P, B, S, Hkv, D) leaves, as numpy) as the port's per-layer list
    of :class:`~repro_torch.models.layers.KVCache`."""
    from repro_torch.models.layers import KVCache

    out = []
    for i, p in _layer_index(cfg):
        k, v = caches[f"sub_{i}"]
        out.append(KVCache(array_from_numpy(np.asarray(k)[p], device),
                           array_from_numpy(np.asarray(v)[p], device)))
    return out

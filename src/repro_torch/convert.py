"""Move params, images and LM caches into the port's tensors.

CNN params keep the reference package's structure: a list aligned with
``net.layers`` of ``{"w": (k, k, Cin, Cout), "b": (Cout,)}`` per conv and
``{}`` per pool — plain dicts, not ``nn.Module``s, because the span
engine slices them by layer index. LM params become the port's
``DecoderParams`` (``EncDecParams`` for an encoder-decoder config): the
reference's stacked periods unstacked into one layer each, every weight
in the same (in, out) layout. Inputs may be
numpy arrays (including bfloat16 ones), anything ``numpy.asarray``
accepts, or tensors. The way back, to the reference's stacked tree
(``lm_params_to_numpy``, ``adamw_state_to_numpy``), lets the tests
compare a gradient or an optimizer state leaf by leaf.
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


def reference_path(name: str, cfg) -> tuple[tuple[str, ...], int | None]:
    """The reference's tree path of the port's parameter ``name`` (as
    ``named_parameters()`` gives it) and, for a leaf stacked on a leading
    period or layer axis there, the index on that axis (``None`` for an
    unstacked leaf)."""
    head, *rest = name.split(".")
    if head == "layers":
        l = int(rest[0])
        return ("periods", f"sub_{l % cfg.period}", *rest[1:]), l // cfg.period
    if head in ("enc_layers", "dec_layers"):
        return (head[:3], "periods", "sub_0", *rest[1:]), int(rest[0])
    if head == "enc_norm":
        return ("enc", "enc_norm"), None
    return (head,), None


def lm_params_to_numpy(params, cfg, tensors=None) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the reference's
    stacked parameter tree, as numpy (bfloat16 as float32), of the port's
    module ``params``; or, with ``tensors`` (one per parameter in
    ``params.parameters()`` order, such as gradients or Adam moments),
    the same tree of those tensors."""
    named = list(params.named_parameters())
    values = [p for _, p in named] if tensors is None else list(tensors)
    if len(values) != len(named):
        raise ValueError(f"{len(values)} tensors for {len(named)} "
                         f"parameters")
    tree: dict = {}
    stacks: dict = {}  # a stacked leaf's path -> {layer index: array}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for (name, _), t in zip(named, values):
        arr = t.detach().cpu()
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
        path, index = reference_path(name, cfg)
        if index is None:
            put(path, arr)
        else:
            stacks.setdefault(path, {})[index] = arr
    for path, by_layer in stacks.items():
        put(path, np.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree


def adamw_state_from_numpy(state, cfg, device: str | torch.device = "cpu"):
    """The reference's ``AdamWState`` (``m`` and ``v`` trees congruent
    with the parameters, ``count``; arrays as numpy) as the port's
    :class:`~repro_torch.optim.adamw.AdamWState` on ``device``: ``m`` and
    ``v`` unstacked as :func:`lm_params_from_numpy` unstacks the
    parameters, in the port's parameter order."""
    from repro_torch.optim.adamw import AdamWState

    def leaves(tree):
        return [p.detach() for p in
                lm_params_from_numpy(tree, cfg, device).parameters()]

    return AdamWState(leaves(state.m), leaves(state.v),
                      torch.tensor(int(np.asarray(state.count)),
                                   dtype=torch.int32, device=device))


def adamw_state_to_numpy(state, params, cfg) -> tuple:
    """The port's ``AdamWState`` as the reference's ``(m, v, count)``:
    ``m`` and ``v`` as stacked numpy trees shaped like the parameters of
    ``params`` (the module the state belongs to), ``count`` an int32
    scalar array."""
    return (lm_params_to_numpy(params, cfg, state.m),
            lm_params_to_numpy(params, cfg, state.v),
            np.asarray(state.count.cpu().numpy(), np.int32))

"""Unified model API for the LM side: ``build_model(cfg)`` returns a
ModelAPI whose functions serve a decoder-only LM (init, prefill,
decode_step, init_caches), the port of ``repro/models/api.py``.

The reference's ``train_loss`` and its enc-dec branch are not ported yet
(ROADMAP Queue A 10); neither are the deprecated CNN shims
(``span_executor``, ``stap_executor``), whose staged replacement is
``repro_torch.occam``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelCfg

from . import layers, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelCfg
    device: torch.device
    init: Callable[[torch.Generator], transformer.DecoderParams]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[..., tuple[torch.Tensor, Any]]
    init_caches: Callable[..., Any]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU; raises when none is visible."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the LM runs on the GPU by default, and no CUDA device is "
                "visible; pass device=\"cpu\" to run on the CPU")
        device = "cuda"
    return torch.device(device)


def build_model(cfg: ModelCfg, dtype=torch.bfloat16,
                device: str | torch.device | None = None,
                attn_impl: str = "flash") -> ModelAPI:
    """The model's functions on ``device`` (``None``: the GPU).

    ``attn_impl`` picks prefill attention: ``"flash"`` (the CUDA kernel on
    the GPU, its plain version on the CPU) or ``"chunked"`` (the twin of
    the reference's default XLA path). ``init(generator)`` draws the
    parameters with a ``torch.Generator`` on ``device``.
    """
    transformer.check_supported(cfg)
    if attn_impl not in layers.ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {layers.ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    dev = resolve_device(device)

    def init(generator: torch.Generator) -> transformer.DecoderParams:
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lies on {generator.device}; "
                             f"the model on {dev}")
        return transformer.init_decoder_params(cfg, generator, dtype)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=lambda p, b, s_max: transformer.decoder_prefill(
            p, b, cfg, s_max, attn_impl=attn_impl),
        decode_step=lambda p, t, c, pos: transformer.decoder_decode_step(
            p, t, c, pos, cfg),
        init_caches=lambda b, s_max: transformer.init_decoder_caches(
            cfg, b, s_max, dtype, dev),
    )


def make_batch(cfg: ModelCfg, batch: int, seq: int,
               generator: torch.Generator | None = None,
               device=None) -> dict:
    """Synthetic batch matching the arch's input signature: ``tokens``
    and ``labels`` (B, S) in [0, vocab), and (B, S, 3) ``positions`` for
    M-RoPE configs. Drawn with ``generator`` (a CPU generator seeded 0
    by default) and moved to ``device`` (default: the generator's)."""
    if cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec batches come with the enc-dec models "
            "(ROADMAP Queue A 10)")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = generator.device if device is None else device

    def tokens():
        return torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                             device=generator.device).to(device)

    b: dict[str, Any] = {"tokens": tokens(), "labels": tokens()}
    if cfg.mrope_sections is not None:  # VLM backbone: 3-D positions (t,h,w)
        pos = torch.arange(seq, dtype=torch.int32, device=device)
        b["positions"] = pos[None, :, None].expand(batch, seq, 3)
    return b

"""Unified model API — and the deprecated one-call CNN executor shims,
the port of ``repro/models/api.py``.

* ``build_model(cfg)`` returns a ModelAPI whose functions train and serve
  a decoder-only or an encoder-decoder LM (init, train_loss, prefill,
  decode_step, init_caches). ``train_loss`` always runs the chunked
  attention and SSD twins, whatever ``attn_impl`` and ``ssd_impl`` say:
  the reference trains through XLA, not its Pallas kernels, and neither
  CUDA kernel has a backward.
* ``span_executor`` / ``stap_executor`` — the legacy one-call CNN entry
  points, thin **deprecated** shims over the staged deployment API
  (``repro_torch.occam``: ``plan -> place -> compile -> run``), which
  new code uses directly.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelCfg

from . import encdec, layers, mamba, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelCfg
    device: torch.device
    init: Callable[[torch.Generator], torch.nn.Module]
    train_loss: Callable[..., tuple[torch.Tensor, dict]]
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
                attn_impl: str = "flash",
                ssd_impl: str = "kernel") -> ModelAPI:
    """The model's functions on ``device`` (``None``: the GPU).

    ``attn_impl`` picks prefill attention: ``"flash"`` (the CUDA kernel on
    the GPU, its plain version on the CPU) or ``"chunked"`` (the twin of
    the reference's default XLA path). ``ssd_impl`` picks prefill's SSD
    scan in Mamba layers the same way: ``"kernel"`` (the CUDA SSD-scan
    kernel on the GPU, its plain version on the CPU) or ``"chunked"`` (the
    twin of the reference's ``ssd_chunked``); ``train_loss(params,
    batch)`` always takes the chunked twins. ``init(generator)`` draws
    the parameters with a ``torch.Generator`` on ``device``; on
    ``device="meta"``, ``init()`` builds the same modules of ``meta``
    tensors and draws nothing (the twin of the reference's
    ``jax.eval_shape(api.init, key)``). An
    encoder-decoder config (``cfg.is_enc_dec``) gets the enc-dec stack,
    whose prefill reads ``enc_embeds`` and ``tokens`` from the batch and
    whose ``init_caches(b, s_max, s_enc=None)`` sizes the cross caches
    to ``s_enc`` (default ``s_max``), as the reference's.
    """
    if attn_impl not in layers.ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {layers.ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    if ssd_impl not in mamba.SSD_IMPLS:
        raise ValueError(f"ssd_impl must be one of {mamba.SSD_IMPLS}, "
                         f"got {ssd_impl!r}")
    dev = resolve_device(device)

    def init(generator: torch.Generator | None = None) -> torch.nn.Module:
        if generator is None:
            if dev.type != "meta":
                raise ValueError(f"init draws the parameters with a "
                                 f"generator on {dev}; only a model on "
                                 f"the meta device builds without one")
            generator = layers.META_DRAW
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lies on {generator.device}; "
                             f"the model on {dev}")
        if cfg.is_enc_dec:
            return encdec.init_encdec_params(cfg, generator, dtype)
        return transformer.init_decoder_params(cfg, generator, dtype)

    if cfg.is_enc_dec:
        return ModelAPI(
            cfg=cfg,
            device=dev,
            init=init,
            train_loss=lambda p, b: encdec.encdec_lm_loss(p, b, cfg),
            prefill=lambda p, b, s_max: encdec.encdec_prefill(
                p, b, cfg, s_max, attn_impl=attn_impl),
            decode_step=lambda p, t, c, pos: encdec.encdec_decode_step(
                p, t, c, pos, cfg),
            init_caches=lambda b, s_max, s_enc=None:
                encdec.init_encdec_caches(cfg, b, s_max, s_enc or s_max,
                                          dtype, dev),
        )
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        train_loss=lambda p, b: transformer.decoder_lm_loss(p, b, cfg),
        prefill=lambda p, b, s_max: transformer.decoder_prefill(
            p, b, cfg, s_max, attn_impl=attn_impl, ssd_impl=ssd_impl),
        decode_step=lambda p, t, c, pos: transformer.decoder_decode_step(
            p, t, c, pos, cfg),
        init_caches=lambda b, s_max, s_enc=None:
            transformer.init_decoder_caches(cfg, b, s_max, dtype, dev),
    )


def span_executor(params: list[dict], xs, net, capacity_elems: int, *,
                  counter=None, device=None):
    """Deprecated shim: single-device Occam execution in one call.

    Equivalent to ``occam.plan(net, capacity_elems, batch=B).place()
    .compile(device=device).run(params, xs)`` (bit-identical — the staged
    API runs the same DP, routes, and engines; ``device=None`` is the
    GPU). Returns ``(y, result)`` where ``result`` is the executed
    :class:`~repro_torch.core.partition.PartitionResult`.
    """
    warnings.warn(
        "span_executor is deprecated; use repro_torch.occam: "
        "plan(net, capacity).place().compile().run(params, xs)",
        DeprecationWarning, stacklevel=2)
    from repro_torch import occam

    batch = xs.shape[0] if xs.ndim == 4 else 1
    dep = occam.plan(net, capacity_elems, batch=batch).place() \
        .compile(device=device)
    y = dep.run(params, xs, counter=counter)
    return y, dep.plan.partition


def stap_executor(params: list[dict], xs, net, capacity_elems: int, *,
                  microbatch: int = 1, stage_times=None, max_chips=None,
                  max_replicas=None, target_period=None, mesh=None,
                  devices=None, counter=None, device=None):
    """Deprecated shim: multi-chip STAP pipeline execution in one call.

    Equivalent to ``occam.plan(net, capacity_elems, batch=microbatch)
    .place(chips=max_chips, stage_times=..., pipeline=True)
    .compile(device=device).run(params, xs)`` (bit-identical — same plan
    defaulting, same pipeline program). Returns ``(y, pipeline)`` where
    ``pipeline`` is the compiled
    :class:`~repro_torch.runtime.stap_pipeline.StapPipeline`.
    """
    warnings.warn(
        "stap_executor is deprecated; use repro_torch.occam: "
        "plan(net, capacity, batch=microbatch).place(chips=..., "
        "pipeline=True).compile().run(params, xs)",
        DeprecationWarning, stacklevel=2)
    from repro_torch import occam

    if xs.ndim != 4:
        raise ValueError("stap_executor streams batched (B, H, W, C)")
    dep = occam.plan(net, capacity_elems, batch=microbatch) \
        .place(chips=max_chips, stage_times=stage_times,
               max_replicas=max_replicas, target_period=target_period,
               microbatch=microbatch, mesh=mesh, devices=devices,
               pipeline=True) \
        .compile(device=device)
    y = dep.run(params, xs, counter=counter)
    return y, dep.pipeline(xs.shape[0])


def make_batch(cfg: ModelCfg, batch: int, seq: int,
               generator: torch.Generator | None = None,
               device=None, dtype=torch.float32) -> dict:
    """Synthetic batch matching the arch's input signature: ``tokens``
    and ``labels`` (B, S) in [0, vocab), (B, S, 3) ``positions`` for
    M-RoPE configs, and for an encoder-decoder config ``enc_embeds``
    (B, S, d_model) N(0, 1) frame embeddings in ``dtype``. Drawn with
    ``generator`` (a CPU generator seeded 0 by default) and moved to
    ``device`` (default: the generator's)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = generator.device if device is None else device

    def tokens():
        return torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                             device=generator.device).to(device)

    if cfg.is_enc_dec:
        enc = torch.randn((batch, seq, cfg.d_model), generator=generator,
                          device=generator.device)
        return {"enc_embeds": enc.to(device, dtype), "tokens": tokens(),
                "labels": tokens()}
    b: dict[str, Any] = {"tokens": tokens(), "labels": tokens()}
    if cfg.mrope_sections is not None:  # VLM backbone: 3-D positions (t,h,w)
        pos = torch.arange(seq, dtype=torch.int32, device=device)
        b["positions"] = pos[None, :, None].expand(batch, seq, 3)
    return b

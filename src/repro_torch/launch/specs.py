"""Cell assembly for the dry run: input stand-ins + sharding trees for
every (arch x shape x mesh) combination, the port of
``repro/launch/specs.py``.

Nothing here allocates device memory unless asked to: without a
generator, params/optimizer/caches are built on the ``meta`` device (the
twin of ``jax.eval_shape``) and inputs are ``meta`` tensors (the twin of
``ShapeDtypeStruct``s). With a generator, :func:`build_cell` draws the
same cell's values on the generator's device, so a run of the cell on a
card can be held against its ``meta`` record.

Shardings are ``sharding.NamedSpec``s (a mesh and a ``P``) over a
``DeviceMesh`` whose positions may all be ``torch.device("meta")``.
Eager PyTorch partitions nothing: the specs say what each position would
hold, and the dry run counts their bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs import ModelCfg, ShapeCfg
from repro_torch.models import sharding as shmod
from repro_torch.models.api import build_model
from repro_torch.models.encdec import CrossCache
from repro_torch.models.layers import KVCache
from repro_torch.models.mamba import SSMCache
from repro_torch.models.sharding import P, NamedSpec, ShardCtx
from repro_torch.models.transformer import cache_axes, param_spec_tree
from repro_torch.optim.adamw import AdamW, AdamWState

from .mesh import data_axes as mesh_data_axes
from .train_step import make_train_step, microbatch_policy

_CACHE_TYPES = (KVCache, SSMCache, CrossCache)


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: the stand-in for a ``ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _data_positions(mesh, daxes) -> int:
    return math.prod(mesh.shape[a] for a in daxes)


def make_ctx(mesh, multi_pod: bool, shape: ShapeCfg) -> ShardCtx:
    """ShardCtx with cache symbols resolved for this cell's batch size."""
    daxes = mesh_data_axes(multi_pod)
    dp = _data_positions(mesh, daxes)
    b = shape.global_batch
    if b % dp == 0:
        cache_b: Any = daxes if len(daxes) > 1 else daxes[0]
        cache_s: Any = "model"
    else:  # e.g. long_500k B=1 — shard the sequence over everything
        cache_b = None
        cache_s = daxes + ("model",)
    # The reference's sequence-parallel residual stream, on for training.
    # The symbol is resolved as the reference resolves it; eager PyTorch
    # partitions nothing, so no value or count of the port depends on it.
    act_seq = "model" if shape.kind == "train" else None
    return ShardCtx(
        mesh=mesh,
        data_axes=daxes,
        model_axis="model",
        symbols=(("cache_b", cache_b), ("cache_s", cache_s),
                 ("act_seq", act_seq)),
    )


def batch_partition(ctx: ShardCtx, global_batch: int):
    if global_batch % _data_positions(ctx.mesh, ctx.data_axes) == 0:
        return ctx.data_axes if len(ctx.data_axes) > 1 else ctx.data_axes[0]
    return None


def input_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict:
    """``meta`` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": sds((b, 1), torch.int32),
                "pos": sds((), torch.int32)}
    specs = {"tokens": sds((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = sds((b, s), torch.int32)
    if cfg.is_enc_dec:
        specs["enc_embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)
    if cfg.mrope_sections is not None:
        specs["positions"] = sds((b, s, 3), torch.int32)
    return specs


def batch_shardings(ctx: ShardCtx, specs: dict, global_batch: int) -> dict:
    bspec = batch_partition(ctx, global_batch)
    out = {}
    for k, v in specs.items():
        if k == "pos":
            out[k] = NamedSpec(ctx.mesh, P())
        else:
            out[k] = NamedSpec(ctx.mesh, P(bspec, *([None] * (v.ndim - 1))))
    return out


def param_shardings(ctx: ShardCtx, params) -> dict[str, NamedSpec]:
    """``{name: NamedSpec}`` keyed by ``params.named_parameters()``."""
    specs = param_spec_tree(params)
    with shmod.use_shardings(ctx):
        return {name: NamedSpec(ctx.mesh, shmod.resolve(*spec))
                for name, spec in specs.items()}


def _map_caches(fn, caches):
    """``caches`` (a list per layer of caches, or of dicts of them) with
    ``fn`` applied to every leaf tensor, structure kept."""
    if isinstance(caches, _CACHE_TYPES):
        return type(caches)(*(fn(leaf) for leaf in caches))
    if isinstance(caches, dict):
        return {k: _map_caches(fn, v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [_map_caches(fn, c) for c in caches]
    raise TypeError(f"not a cache tree: {type(caches).__name__}")


def cache_shardings(ctx: ShardCtx, caches) -> Any:
    """The caches' tree with a ``NamedSpec`` per leaf. The port's caches
    are per layer, so a leaf's rank is the reference's stacked rank less
    one: ``cache_axes`` takes ``ndim + 1`` and its leading ``None`` goes."""
    with shmod.use_shardings(ctx):
        def f(leaf):
            axes = cache_axes(leaf.ndim + 1)
            if axes is None:
                return NamedSpec(ctx.mesh, P())
            return NamedSpec(ctx.mesh, shmod.resolve(*axes[1:]))

        return _map_caches(f, caches)


def opt_shardings(ctx: ShardCtx, opt_state: AdamWState,
                  p_shardings: dict[str, NamedSpec]) -> AdamWState:
    """m/v shard like their params (in parameter order); count
    replicated."""
    specs = list(p_shardings.values())
    return AdamWState(m=specs, v=specs, count=NamedSpec(ctx.mesh, P()))


@dataclasses.dataclass
class Cell:
    """Everything needed to run one (arch x shape) on a mesh."""

    fn: Any                  # callable on args
    args: tuple              # meta stand-ins, or values drawn on a device
    in_shardings: tuple
    donate_argnums: tuple    # the arguments the call updates in place
    label: str
    microbatches: int = 1
    host_reads: tuple = ()   # arguments read as Python numbers on the host


def _batch(cfg: ModelCfg, specs: dict, generator) -> dict:
    """Values for the input stand-ins ``specs`` on ``generator``'s
    device: tokens and labels uniform in [0, vocab), ``positions``
    0..S-1 on each of the three M-RoPE axes, ``enc_embeds`` N(0, 1)."""
    dev = generator.device
    out = {}
    for k, v in specs.items():
        if k == "enc_embeds":
            out[k] = torch.randn(v.shape, generator=generator, device=dev,
                                 dtype=torch.float32).to(v.dtype)
        elif k == "positions":
            s = v.shape[-2]
            pos = torch.arange(s, dtype=v.dtype, device=dev)[:, None]
            out[k] = pos.expand(v.shape).contiguous()
        else:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=generator,
                                   device=dev, dtype=v.dtype)
    return out


def build_cell(cfg: ModelCfg, shape: ShapeCfg, ctx: ShardCtx,
               generator: torch.Generator | None = None,
               microbatches: int | None = None) -> Cell:
    """The cell of ``cfg`` at ``shape`` on ``ctx.mesh``: its function, its
    arguments and their shardings.

    Without ``generator`` every argument is a ``meta`` stand-in; with
    one, the parameters are drawn as ``build_model(...).init`` draws them
    and the inputs as :func:`_batch` does, on the generator's device.
    The function runs the chunked attention and SSD twins (the
    reference's XLA path). A train cell takes ``microbatches`` (default:
    ``microbatch_policy`` over the mesh's data positions) on a leading
    axis of every batch leaf. A decode cell's ``pos`` is a host int32
    scalar, ``seq_len - 1``: the port's decode step reads it as an int,
    which feeds the device wherever an attention layer reads a position
    (RoPE, the KV slot); an attention-free model reads none, so there the
    reference's program has no such argument.
    """
    dev = "meta" if generator is None else generator.device
    api = build_model(cfg, device=dev, attn_impl="chunked",
                      ssd_impl="chunked")
    params = api.init(generator)
    p_sh = param_shardings(ctx, params)
    specs = input_specs(cfg, shape)
    b_sh = batch_shardings(ctx, specs, shape.global_batch)

    if shape.kind == "train":
        opt = AdamW()
        m = microbatches or microbatch_policy(
            cfg.param_count()[0], shape.global_batch,
            _data_positions(ctx.mesh, ctx.data_axes))
        step = make_train_step(api, opt, microbatches=m)
        opt_state = opt.init(params)
        o_sh = opt_shardings(ctx, opt_state, p_sh)
        if m > 1:  # leading microbatch dim on every batch leaf
            specs = {k: sds((m, v.shape[0] // m, *v.shape[1:]), v.dtype)
                     for k, v in specs.items()}
            b_sh = {k: NamedSpec(ctx.mesh, P(None, *s.spec))
                    for k, s in b_sh.items()}
        batch = specs if generator is None else _batch(cfg, specs, generator)
        return Cell(
            fn=step,
            args=(params, opt_state, batch),
            in_shardings=(p_sh, o_sh, b_sh),
            donate_argnums=(0, 1),
            label=f"{cfg.name}/{shape.name}/train_step[m={m}]",
            microbatches=m,
        )

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return api.prefill(params, batch, shape.seq_len)

        batch = specs if generator is None else _batch(cfg, specs, generator)
        return Cell(
            fn=prefill_fn,
            args=(params, batch),
            in_shardings=(p_sh, b_sh),
            donate_argnums=(),
            label=f"{cfg.name}/{shape.name}/prefill",
        )

    # decode: one new token against a seq_len cache
    b = shape.global_batch
    if cfg.is_enc_dec:
        caches = api.init_caches(b, shape.seq_len, shape.seq_len)
    else:
        caches = api.init_caches(b, shape.seq_len)
    c_sh = cache_shardings(ctx, caches)
    tokens = specs["tokens"]
    if generator is not None:
        tokens = _batch(cfg, {"tokens": tokens}, generator)["tokens"]
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)

    def decode_fn(params, tokens, caches, pos):
        return api.decode_step(params, tokens, caches, pos)

    return Cell(
        fn=decode_fn,
        args=(params, tokens, caches, pos),
        in_shardings=(p_sh, b_sh["tokens"], c_sh, b_sh["pos"]),
        donate_argnums=(2,),
        label=f"{cfg.name}/{shape.name}/serve_step",
        host_reads=() if cfg.attention_free else (3,),
    )

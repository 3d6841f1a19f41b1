"""Sharding context: translate symbolic axes to mesh partition specs, the
port of ``repro/models/sharding.py``.

Model code names *symbolic* axes; a ShardCtx (installed by the caller with
``use_shardings``) maps them onto the real mesh axes:

    "data"  -> ctx.data_axes   (("data",) single-pod, ("pod", "data") multi)
    "model" -> ctx.model_axis
    "both"  -> data_axes + (model_axis,)

The context's mesh is the port's ``DeviceMesh`` (one controller over a
grid of positions, a device may repeat). What reads it executes across
its positions: the MoE layer's expert-parallel path
(``moe_sublayer`` chooses ``impl="ep_shard_map"`` under a context).

What has no eager counterpart:

- ``shard(x, *axes)`` returns ``x``. In the reference it is
  ``with_sharding_constraint``, a hint to XLA's SPMD partitioner; eager
  PyTorch has no partitioner to steer, and the port's model code calls
  no ``shard``.
- ``shard_map_compat`` is not ported: the port's executors are
  one-controller loops over a mesh's positions
  (``runtime/stap_pipeline.py``, ``runtime/pipeline.py``, the MoE layer's
  expert-parallel path, ``optim.compression.allreduce_compressed``).
- ``resolve`` returns ``P``, a tuple twin of JAX's ``PartitionSpec``, and
  ``named`` a ``(mesh, spec)`` record in place of a ``NamedSharding``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Iterator, NamedTuple

if TYPE_CHECKING:
    from repro_torch.runtime.stap_pipeline import DeviceMesh


class P(tuple):
    """A partition spec: one entry per array dimension, each a mesh-axis
    name, a tuple of names or None (the twin of JAX's ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSpec(NamedTuple):
    """A spec on a mesh (the twin of JAX's ``NamedSharding``)."""

    mesh: "DeviceMesh"
    spec: P


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: "DeviceMesh"
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # extra symbolic axes (e.g. cache_b/cache_s decode layouts); values are
    # raw PartitionSpec entries: a mesh-axis name, tuple of names, or None.
    symbols: tuple[tuple[str, object], ...] = ()


_CTX: ShardCtx | None = None


@contextlib.contextmanager
def use_shardings(ctx: ShardCtx | None) -> Iterator[None]:
    global _CTX
    prev, _CTX = _CTX, ctx
    try:
        yield
    finally:
        _CTX = prev


def current_ctx() -> ShardCtx | None:
    return _CTX


def resolve(*axes) -> P:
    """Symbolic axes -> PartitionSpec under the current context."""
    ctx = _CTX
    assert ctx is not None
    symbols = dict(ctx.symbols)
    out = []
    data = ctx.data_axes if len(ctx.data_axes) > 1 else ctx.data_axes[0]
    defaults = {"act_seq": None, "cache_b": data, "cache_s": ctx.model_axis}
    for a in axes:
        if a is None:
            out.append(None)
        elif a in symbols:
            out.append(symbols[a])
        elif a == "data":
            out.append(data)
        elif a == "model":
            out.append(ctx.model_axis)
        elif a == "both":
            out.append(ctx.data_axes + (ctx.model_axis,))
        elif a in defaults:
            out.append(defaults[a])
        else:
            raise ValueError(f"unknown symbolic axis {a!r}")
    return P(*out)


def shard(x, *axes):
    """The identity: eager PyTorch has no SPMD partitioner for a sharding
    constraint to steer."""
    return x


def named(*axes) -> NamedSpec | None:
    ctx = _CTX
    if ctx is None:
        return None
    return NamedSpec(ctx.mesh, resolve(*axes))

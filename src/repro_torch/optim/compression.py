"""Int8 error-feedback gradient compression: the port of
``repro/optim/compression.py``.

Each tensor is quantized to int8 with a per-tensor scale, and the
quantization residual is kept locally (error feedback), which preserves
convergence (Seide et al. 2014; Karimireddy et al. 2019). ``torch.round``
rounds half to even, as ``jnp.round`` does, so ``q`` is the reference's
bit for bit.

A pytree here is a sequence of tensors (a module's parameters or their
gradients, in order). The reference's ``allreduce_compressed`` is a
``psum`` inside ``shard_map`` over a mesh axis; it comes with the mesh
modules (ROADMAP Queue A 3.5) and raises until then.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class EFState(NamedTuple):
    residual: list[torch.Tensor]  # congruent with the gradients (fp32)


def init_ef(grads_like: Sequence[torch.Tensor]) -> EFState:
    return EFState([torch.zeros(g.shape, dtype=torch.float32,
                                device=g.device) for g in grads_like])


def compress(g: torch.Tensor, residual: torch.Tensor):
    """-> (q int8, scale fp32 0-d tensor, new_residual)."""
    x = g.float() + residual
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.float() * scale
    return q, scale, new_residual


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Sequence[torch.Tensor], state: EFState):
    """Compress each tensor. Returns ((q_list, scale_list), new_state)."""
    if len(grads) != len(state.residual):
        raise ValueError(f"{len(grads)} gradients, "
                         f"{len(state.residual)} residuals")
    qs, scales, residuals = [], [], []
    for g, r in zip(grads, state.residual):
        q, s, nr = compress(g, r)
        qs.append(q)
        scales.append(s)
        residuals.append(nr)
    return (qs, scales), EFState(residuals)


def decompress_tree(q_tree: Sequence[torch.Tensor],
                    scale_tree: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [decompress(q, s) for q, s in zip(q_tree, scale_tree)]


def allreduce_compressed(grads, state: EFState, axis_name: str,
                         n_participants: int):
    """The reference's int8 all-reduce over a mesh axis inside
    ``shard_map``; not ported yet."""
    raise NotImplementedError(
        "allreduce_compressed reduces over a mesh axis inside shard_map; "
        "the mesh modules are not ported yet (ROADMAP Queue A 3.5). "
        "compress_tree and decompress_tree run on one device")

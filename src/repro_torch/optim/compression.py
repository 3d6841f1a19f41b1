"""Int8 error-feedback gradient compression: the port of
``repro/optim/compression.py``.

Each tensor is quantized to int8 with a per-tensor scale, and the
quantization residual is kept locally (error feedback), which preserves
convergence (Seide et al. 2014; Karimireddy et al. 2019). ``torch.round``
rounds half to even, as ``jnp.round`` does, so ``q`` is the reference's
bit for bit.

A pytree here is a sequence of tensors (a module's parameters or their
gradients, in order). ``allreduce_compressed`` runs on one controller
over the positions of a ``DeviceMesh`` axis (the reference's is called
once per participant inside ``shard_map``).
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


def allreduce_compressed(grads: Sequence[Sequence[torch.Tensor]],
                         states: Sequence[EFState], mesh,
                         axis_name: str):
    """Error-feedback int8 all-reduce over the positions of ``mesh``'s
    axis ``axis_name`` (a ``runtime.stap_pipeline.DeviceMesh``).

    The reference's ``allreduce_compressed(grads, state, axis_name,
    n_participants)`` runs once per participant inside ``shard_map``;
    here one controller takes every participant's gradient list and
    ``EFState``, ``grads[p]`` and ``states[p]`` for position p along the
    axis (on its device), and ``n_participants`` is the axis's length.
    Each position compresses its own tensors; the int8 payloads are
    summed in int32 (no overflow below 2^24 participants) and the scales
    summed, on the first position's device, then rescaled by the mean of
    scales — the standard EF-mean estimator, ``sum * mean_scale / n``.
    Returns (means, new_states), one of each per position, each mean
    copied to its position's device.
    """
    devs = mesh.along(axis_name)
    n = len(devs)
    if len(grads) != n or len(states) != n:
        raise ValueError(f"{len(grads)} gradient lists and {len(states)} "
                         f"states for the {n} positions of axis "
                         f"{axis_name!r}")
    packed = [compress_tree(g, st) for g, st in zip(grads, states)]
    means = []
    for leaf in range(len(grads[0])):
        qs = [q[leaf].to(devs[0]) for (q, _), _ in packed]
        summed = qs[0].to(torch.int32)
        for q in qs[1:]:
            summed = summed + q.to(torch.int32)
        scale_sum = packed[0][0][1][leaf].to(devs[0])
        for (_, s), _ in packed[1:]:
            scale_sum = scale_sum + s[leaf].to(devs[0])
        scale_mean = scale_sum / n
        means.append(summed.float() * scale_mean / n)
    return ([[m.to(dev) for m in means] for dev in devs],
            [new_state for _, new_state in packed])

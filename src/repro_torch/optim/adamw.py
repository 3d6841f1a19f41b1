"""AdamW + cosine schedule + global-norm clipping: the port of
``repro/optim/adamw.py``.

A twin of the reference's update, not ``torch.optim.AdamW``, which
differs from it: the gradients are clipped by their global norm, the
learning rate is read at ``count + 1``, the decoupled decay is added to
the Adam step before the learning rate scales it, and the bias
corrections are ``b ** count`` in fp32. The state keeps the reference's
layout, ``AdamWState(m, v, count)``: ``m`` and ``v`` are fp32 tensors
(for bf16 parameters too) in the order of the parameters, ``count`` a
0-d int32 tensor, so checkpoints and parity tests map one to one.

``update`` changes the parameters and the state in place under
``torch.no_grad()``, and returns ``{"grad_norm", "lr"}`` as 0-d tensors
on the parameters' device: the clip scale, the learning rate and the bias
corrections never leave the device, so a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import torch
from torch import nn


class AdamWState(NamedTuple):
    m: list[torch.Tensor]
    v: list[torch.Tensor]
    count: torch.Tensor


def param_leaves(params) -> list[torch.Tensor]:
    """The tensors of ``params``: an ``nn.Module``'s parameters (in
    ``state_dict()`` order) or a sequence of tensors."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params) -> AdamWState:
        leaves = param_leaves(params)
        if not leaves:
            raise ValueError("AdamW.init: no parameters")

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(
            m=[zeros(p) for p in leaves],
            v=[zeros(p) for p in leaves],
            count=torch.zeros((), dtype=torch.int32,
                              device=leaves[0].device),
        )

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=count.device)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params) -> dict:
        """One step: ``params`` (a module or a sequence of tensors) and
        ``state`` updated in place from ``grads`` (aligned with the
        parameters). Returns ``{"grad_norm", "lr"}``, 0-d fp32 tensors."""
        leaves = param_leaves(params)
        grads = list(grads)
        if not len(grads) == len(leaves) == len(state.m) == len(state.v):
            raise ValueError(f"{len(grads)} gradients, {len(leaves)} "
                             f"parameters, {len(state.m)} moments")
        state.count.add_(1)
        cf = state.count.float()
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        mhat_scale = 1.0 / (1 - b1 ** cf)
        vhat_scale = 1.0 / (1 - b2 ** cf)
        lr = self._lr(state.count)
        for p, g, m, v in zip(leaves, grads, state.m, state.v):
            g = g.float()
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step = m * mhat_scale / (torch.sqrt(v * vhat_scale) + self.eps)
            p32 = p.float()
            step = step + self.weight_decay * p32
            p.copy_(p32 - lr * step)
        return {"grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares, in fp32 (a sequence of
    tensors, or a module's parameters)."""
    leaves = param_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    down to ``floor * peak`` at ``total``; a function of the 0-d count
    tensor, computed on its device in fp32."""
    def lr(count):
        c = count.float()
        warm = peak * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)

    return lr
